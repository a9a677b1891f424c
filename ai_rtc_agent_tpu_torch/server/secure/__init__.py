"""Secure media transport: ICE-lite STUN, DTLS 1.2, SRTP (the port's copy of
ai_rtc_agent_tpu/server/secure/).

Without aiortc, the agent implements the protocols itself on top of the
``cryptography`` primitive library (no pyOpenSSL):

  * stun.py      RFC 5389 messages + the ICE-lite binding responder
                 (RFC 8445 s2.5 — we never initiate checks)
  * dtls.py      sans-IO DTLS 1.2 (RFC 6347) server+client,
                 ECDHE + ECDSA-P256, AES-128-GCM, use_srtp (RFC 5764),
                 RFC 5705 keying-material exporter
  * srtp.py      RFC 3711 SRTP/SRTCP, AES128_CM_HMAC_SHA1_80
  * endpoint.py  RFC 7983 demux glueing the three onto one UDP socket
  * sctp.py      RFC 9260 subset + DCEP datachannels (pure stdlib)

Exports resolve lazily (PEP 562): importing the crypto-free members
(``sctp``) or probing for availability must not explode on a box without
``cryptography`` — the signaling tier degrades to loopback there instead
of dying at import.
"""

_EXPORTS = {
    "StunMessage": "stun",
    "IceLiteResponder": "stun",
    "SrtpContext": "srtp",
    "derive_srtp_contexts": "srtp",
    "DtlsEndpoint": "dtls",
    "generate_certificate": "dtls",
    "SecureMediaSession": "endpoint",
    "classify": "endpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
