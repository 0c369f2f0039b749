"""Serve a serving artifact over HTTP.

    python -m bridgerl_tpu_torch.cli.export_serving --ckpt CKPT.pth --out serving/model.zip
    python -m bridgerl_tpu_torch.cli.serve_http --artifact serving/model.zip --port 8764

    curl -s -X POST --data-binary @human_windows.npy \
        -H 'Content-Type: application/octet-stream' \
        http://127.0.0.1:8764/v1/retarget -o joints.npy

The flags and defaults of ``scripts/serve_http.py`` (``export/server.py``
has the endpoints), plus ``--device`` (default ``cuda``): the artifact's
programs for that platform serve; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", type=str, required=True, help="serving .zip")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8764)
    p.add_argument("--no-bucket", action="store_true",
                   help="disable power-of-two batch bucketing")
    p.add_argument("--max_requests", type=int, default=None,
                   help="serve N requests then exit (smoke tests)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..export.server import make_server

    srv = make_server(args.artifact, host=args.host, port=args.port,
                      bucket_batches=not args.no_bucket, device=args.device)
    host, port = srv.server_address
    print(f"[INFO] serving {args.artifact} on http://{host}:{port}/ "
          f"(POST /v1/<function>; Ctrl-C stops)", flush=True)
    try:
        if args.max_requests is None:
            srv.serve_forever()
        else:
            # each request runs in a thread of its own: have server_close wait
            # for them, or the process exits under a request still being served
            srv.daemon_threads = False
            for _ in range(args.max_requests):
                srv.handle_request()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
