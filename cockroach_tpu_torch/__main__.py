"""`python -m cockroach_tpu_torch sql ...` (cli.py)."""

from cockroach_tpu_torch.cli import main

if __name__ == "__main__":
    main()
