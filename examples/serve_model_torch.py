"""Serve a model from the zoo on the PyTorch port: the twin of
``examples/serve_model.py``.

A batched prefill fills the KV/state cache, then greedy decode steps
stream tokens, through ``repro_torch.launch.serve``; mixtral_8x7b's tiny
preset unless ``--arch`` names another family — try an SSM (O(1)-state
decode).  On the card this runs the flash prefill and decode kernels.

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/serve_model_torch.py
      PYTHONPATH=src python examples/serve_model_torch.py --arch rwkv6_1_6b
      PYTHONPATH=src python examples/serve_model_torch.py --device cpu
"""
import sys

from repro_torch.launch import serve as serve_cli


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "mixtral_8x7b"] + argv
    if not any(a.startswith("--batch") for a in argv):
        argv += ["--batch", "4", "--prompt-len", "48", "--gen-len", "16"]
    return serve_cli.main(argv)


if __name__ == "__main__":
    main()
