"""``python -m cocoa_torch``: the CLI (cocoa_torch/cli.py)."""

from cocoa_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
