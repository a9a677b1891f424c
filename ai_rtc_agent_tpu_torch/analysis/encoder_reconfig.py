"""Checker: encoder bitrate/GOP mutations flow through reconfigure().

The runtime encoder profile (bitrate, GOP, fps) is mutated from three
directions — the network-adaptation ladder (resilience/netadapt.py), the
``/config`` surface, and geometry-change rebuilds — and they must all
converge on ONE path: :meth:`H264Sink.reconfigure` →
:meth:`H264Encoder.reconfigure` (media/codec.py owns every native call).
A second mutation path is how rate state diverges: a sink that calls
``_lib.tr_h264_encoder_create`` itself resurrects the restart-defaults
bug class (a rebuild silently reverting a live reconfigure) and bypasses
the rebuild-on-next-IDR discipline.  Two rules:

* **tr-call** — any call to a ``tr_h264_*`` native symbol outside
  ``media/codec.py`` (the codec tier) and ``media/native.py`` (the ctypes
  loader, which declares signatures and probes availability).
* **rate-ctor** — constructing ``H264Encoder`` (any import spelling) with
  an explicit ``bitrate``/``gop`` argument (keyword or positional)
  outside ``media/codec.py``.  Rate-less construction elsewhere is fine —
  geometry is the caller's to choose; rate targets are not.

Operator tooling (``scripts/``, ``examples/``, ``bench.py``) is exempt,
same carve-out as bounded-queue; the codec tier and its loader are the
profile's ``codec`` paths.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, ScopedVisitor, dotted, terminal_name

CHECKER = "encoder-reconfig"

# H264Encoder(width, height, fps=30, bitrate=None, gop=60, ...): the
# positional slots that carry rate/cadence targets
_RATE_KWARGS = ("bitrate", "gop")
_RATE_POSITIONS = {3: "bitrate", 4: "gop"}


class _Visitor(ScopedVisitor):
    def __init__(self, mod, encoder_names):
        super().__init__()
        self.mod = mod
        # local names bound to media.codec.H264Encoder via any import
        # spelling (`from ..media.codec import H264Encoder as E`, …)
        self.encoder_names = encoder_names
        self.findings = []

    def _flag(self, node, name, message):
        self.findings.append(
            Finding(CHECKER, self.mod.rel, node.lineno, name, message, self.scope)
        )

    def visit_Call(self, node):
        tail = terminal_name(node.func)
        if tail.startswith("tr_h264_"):
            self._flag(
                node, tail,
                f"direct native encoder call {tail} outside media/codec.py — "
                "every tr_h264_* mutation belongs to the codec tier; use "
                "H264Encoder.reconfigure() / H264Sink.reconfigure()",
            )
        elif self._is_encoder_ctor(node):
            rate_args = [
                kw.arg for kw in node.keywords if kw.arg in _RATE_KWARGS
            ] + [
                name
                for i, name in _RATE_POSITIONS.items()
                if len(node.args) > i
            ]
            if rate_args:
                self._flag(
                    node, dotted(node.func) or "H264Encoder",
                    "H264Encoder constructed with explicit "
                    f"{'/'.join(sorted(set(rate_args)))} outside "
                    "media/codec.py — rate/GOP targets must flow through "
                    "the single reconfigure() path",
                )
        self.generic_visit(node)

    def _is_encoder_ctor(self, node) -> bool:
        if isinstance(node.func, ast.Name):
            return node.func.id in self.encoder_names
        return terminal_name(node.func) == "H264Encoder"


def _encoder_import_names(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "H264Encoder":
                    names.add(a.asname or a.name)
    return names


def check(project, profile=PORT) -> list:
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel) or mod.rel in profile.codec:
            continue
        v = _Visitor(mod, _encoder_import_names(mod.tree))
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
