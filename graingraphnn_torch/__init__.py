"""graingraphnn_torch — the device-resident grain-graph rollout and the
models' training in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

A port of `graingraphnn_tpu` that mirrors its module layout and function
names. Plain tensor code is PyTorch; the two kernels that the JAX package
wrote in Pallas (the fused PeriodConv edge stage and the single-launch
topology editor) are CUDA C++ under `csrc/`, built with nvcc on first use
into `_build/` and bound through ctypes (`kernels/_build.py`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`. Every kernel wrapper takes its plain PyTorch version only
for CPU tensors; for CUDA tensors it launches the kernel or raises. The
conv's callers choose between its kernels (inference and evaluation
forwards, no autograd) and its torch formulation (the train step, under
autograd) with `kernels=`.

This package never imports JAX or anything of `graingraphnn_tpu`.
"""

__version__ = "0.1.0"
