"""Deploy-time CLIs of the port: the model downloader (download.py) and the
serving preflight (build_engines.py)."""
