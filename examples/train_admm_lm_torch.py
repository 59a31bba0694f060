"""Train an LM with consensus ADMM on the PyTorch port: the twin of
``examples/train_admm_lm.py``.

Default runs a ~100M-parameter model for a few hundred rounds, resuming
from its checkpoint directory; pass --quick for a tiny config and 12
rounds.  Every round is K_w local Adam steps per worker + ONE consensus
all-reduce, through ``repro_torch.launch.train``.  The checkpoints go to
``/tmp/repro_torch_admm_ck``, not to the reference example's directory:
the two packages share a checkpoint format, and neither run may resume
the other's.

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/train_admm_lm_torch.py --quick
      PYTHONPATH=src python examples/train_admm_lm_torch.py   # ~100M run
      PYTHONPATH=src python examples/train_admm_lm_torch.py --quick --device cpu
"""
import argparse

from repro_torch.launch import train as train_cli

CHECKPOINT_DIR = "/tmp/repro_torch_admm_ck"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="tiny config, 12 rounds")
    ap.add_argument("--steps", type=int, default=None)
    args, rest = ap.parse_known_args(argv)

    if args.quick:
        argv = ["--arch", "qwen2_7b", "--mode", "admm", "--preset", "tiny",
                "--steps", str(args.steps or 12), "--batch", "8",
                "--seq", "128", "--workers", "4", "--local-steps", "2",
                "--checkpoint-dir", CHECKPOINT_DIR]
    else:
        argv = ["--arch", "qwen2_7b", "--mode", "admm", "--preset", "100m",
                "--steps", str(args.steps or 300), "--batch", "8",
                "--seq", "512", "--workers", "4", "--local-steps", "4",
                "--checkpoint-dir", CHECKPOINT_DIR, "--resume"]
    print("[example] equivalent CLI: python -m repro_torch.launch.train "
          + " ".join(argv))
    return train_cli.main(argv + rest)


if __name__ == "__main__":
    main()
