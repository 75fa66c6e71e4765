"""Gateway entry point: ``python -m llmapigateway_tpu_torch [--device cuda]``.

Settings come from ``.env`` / the environment, as for ``python main.py``
(GATEWAY_PORT default 9100, GATEWAY_HOST, GATEWAY_API_KEY,
FALLBACK_PROVIDER, CONFIG_DIR, LOG_LEVEL, ...). ``--device`` places the
local engines: ``cuda`` (the default) or ``cpu``.
"""
import argparse

from .server.app import run


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="python -m llmapigateway_tpu_torch",
        description="OpenAI-compatible gateway with the PyTorch/CUDA engine")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device of the local engines (default: cuda)")
    run(device=parser.parse_args().device)


if __name__ == "__main__":
    main()
