"""``python -m mlrun_tpu_torch.service`` — start the orchestration service
(the same entry as the CLI's ``db`` command); the port's copy of
``mlrun_tpu/service/__main__.py``."""

import argparse

from .app import run_app


def main():
    parser = argparse.ArgumentParser(description="mlrun-tpu API service")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="")
    args = parser.parse_args()
    run_app(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
