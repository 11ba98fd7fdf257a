"""``python -m ray_tpu_torch <command>`` — see ``ray_tpu_torch/scripts/cli.py``."""

from .scripts.cli import main

if __name__ == "__main__":      # an import (a package walk) runs nothing
    raise SystemExit(main())
