"""``python -m open_provence_tpu_torch.train.cli <config.yaml>`` — the
port's trainer CLI (the JAX package's ``train/cli.py``; reference
trainer_cli.py)."""

from .runner import main

if __name__ == "__main__":
    main()
