"""The PGCLSTM cell step's update as one CUDA kernel (csrc/cell_update.cu):
`cell_update_cuda` is what models.cells.apply_pgclstm runs after its three
convs when its caller asks for the kernels (kernels=True) and the messages
are on the card, as ops.period_conv.apply_period_conv picks the conv
kernels. One launch makes both node types' gate sums and biases,
activations and new (h, c). The kernel has no backward: the wrapper raises
when grad mode is on and an input requires grad, and on inputs it cannot
take (not contiguous, 16-byte aligned float32 of the step's shapes).
Everywhere else apply_pgclstm keeps the torch formulation (the gate sums,
then cells._lstm_update), which is this kernel's plain version and the
training path. A null c is the zero state, read as zeros without a read.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import _build

launches = 0   # kernel launches since the caller last set it to 0
COUNTER = "cell_update_launches"   # a recorded build's launches

SOURCE = "cell_update"
NVCC_FLAGS: tuple = ()
NUM_GATES = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
# per part (the joints, then the grains): messages a and b, bias, c, rows,
# h and c out; then C and the stream
ARGTYPES = ([_P] * 4 + [_I] + [_P] * 2) * 2 + [_I, _P]


def _check(part, msgs, bias, c, C):
    n = msgs[0].shape[0]
    dev = msgs[0].device
    tensors = [(f"message {i}", m, (n, NUM_GATES * C))
               for i, m in enumerate(msgs)]
    tensors += [(name, t, shape) for name, t, shape in
                (("bias", bias, (NUM_GATES * C,)), ("c", c, (n, C)))
                if t is not None]
    # the kernel has no backward: its outputs would carry no grad_fn and
    # the cell's weights would silently get no gradient
    if torch.is_grad_enabled():
        grad = [name for name, t, _ in tensors if t.requires_grad]
        if grad:
            raise RuntimeError(
                f"cell update ({part}): the kernel has no backward, and "
                f"{', '.join(grad)} require grad: call it under "
                "torch.no_grad() or take the torch formulation "
                "(kernels=False)")
    for name, t, shape in tensors:
        if t.device != dev:
            raise ValueError(f"cell update ({part}): {name} on {t.device}, "
                             f"messages on {dev}")
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.data_ptr() % 16):
            raise ValueError(
                f"cell update ({part}): {name} must be contiguous, 16-byte "
                f"aligned float32 {shape}, got {t.dtype} {tuple(t.shape)}")


def _part_args(part, msgs, bias, c, C):
    """One part's arguments of the C entry and its (h, c) outputs."""
    if not 1 <= len(msgs) <= 2:
        raise ValueError(f"cell update ({part}): one or two messages")
    bias = bias.reshape(-1)
    _check(part, msgs, bias, c, C)
    a = msgs[0]
    h_out, c_out = (torch.empty((a.shape[0], C), dtype=torch.float32,
                                device=a.device) for _ in range(2))
    b = msgs[1] if len(msgs) == 2 else None
    ptr = [0 if t is None else t.data_ptr() for t in (a, b, bias, c)]
    return [*ptr, a.shape[0], h_out.data_ptr(), c_out.data_ptr()], (h_out,
                                                                    c_out)


def launch(fn, stream, joint, grain, C):
    """Allocate the outputs beside the messages and call the C entry `fn`
    (the built kernel; tests pass a CPU build of the same source) on
    checked inputs. joint and grain are (messages, bias, c): messages a
    tuple of one or two [N, 4C] tensors (summed in their order), bias
    [4, C] or [4C], c [N, C] or None (zeros). Returns ((h, c) of the
    joints, (h, c) of the grains)."""
    if C % 4:
        raise ValueError(f"cell update: C = {C}, not a multiple of 4")
    j_args, j_out = _part_args("joint", *joint, C)
    g_args, g_out = _part_args("grain", *grain, C)
    fn(*j_args, *g_args, C, stream)
    return j_out, g_out


def cell_update_cuda(joint, grain, out_channels: int):
    """The cell step's update on the card, one launch (see launch); a step
    with no rows launches nothing. Counted in `launches` and, inside a
    recorded build, under COUNTER."""
    global launches
    dev = joint[0][0].device
    fn = _build.function(SOURCE, "cell_update_forward", ARGTYPES,
                         NVCC_FLAGS)
    out = launch(fn, torch.cuda.current_stream(dev).cuda_stream, joint,
                 grain, out_channels)
    if joint[0][0].shape[0] + grain[0][0].shape[0] > 0:
        launches += 1
        rec = profiling.recorder()
        if rec is not None:
            rec.add(COUNTER)
    return out
