"""The plain PyTorch reference that decides ``correct``: the configuration's
ncnn graphs as written, before any rewrite, in float32 with TF32 off.

It imports nothing of the program (``rife_tpu_torch``) and nothing of the
JAX package; it reads the model's ``.param`` and ``.bin`` files through the
benchmark's own ``portbench/ncnn.py``.
"""
