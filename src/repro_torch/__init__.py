"""PyTorch/CUDA port of the serverless ADMM system in ``repro``.

It imports torch and numpy, never JAX and never ``repro``.  Entry points
run on the card unless the caller asks for the CPU (``device="cpu"``).
"""
