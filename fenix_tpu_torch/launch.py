"""CLI entry point:
``python -m fenix_tpu_torch.launch <root> [--host] [--port] [--device]``.

Port of ``fenix_tpu/launch.py``; ``--device`` (default ``cuda``) names the
torch device the server keeps its columns on and searches with.
"""

from __future__ import annotations

import argparse
import logging

from fenix_tpu_torch.flight import Server

logging.basicConfig()
LOGGER = logging.getLogger("fenix_tpu_torch")
LOGGER.setLevel(logging.INFO)


def launch(root: str, host: str = "0.0.0.0", port: int = 9001, device: str = "cuda") -> None:
    server = Server(root, host, port, device=device)
    LOGGER.info(f"Server started at {server.grpc} on {server.device}")
    server.serve()


def main() -> None:
    parser = argparse.ArgumentParser(description="fenix_tpu_torch Flight server")
    parser.add_argument("root", help="storage root directory")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9001)
    parser.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cuda:1")
    args = parser.parse_args()
    launch(args.root, args.host, args.port, args.device)


if __name__ == "__main__":
    main()
