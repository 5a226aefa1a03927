"""``python -m sshslie_torch --config config/config.yml --phase train|test|train_and_test [--device cpu]``."""

from sshslie_torch.runner import cli

if __name__ == "__main__":
    cli()
