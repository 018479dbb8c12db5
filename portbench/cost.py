"""The benchmark's frozen yardstick: the H100's datasheet peaks, and the
operations and bytes of one periodic conv as a function, whatever kernels
implement it.

FLOPs are the conv's own, the terms of the port's analytic count (node
projections, the position products, the per-edge shift products, the l2
product, the logits and the softmax), with the per-edge terms counted
over the live edges the inputs hold. Bytes are each input read once
(x_src, x_dst, the neighbour table, edge lengths and mask, the weights at
the configuration's operand width) and the float32 output [Nd, G * C]
written once: no intermediate of any one implementation.

The peaks are NVIDIA's for the H100 SXM at its 700 W limit; the harness
prints the card's power limit beside every share."""

from __future__ import annotations

PEAK_BYTES = 3.35e12                 # HBM3, bytes/s
PEAK_FLOPS = {
    # fp32-accurate products on the tensor cores: TF32 x 3
    "fp32": 495e12 / 3,
    "bf16": 989e12,                  # dense bf16 tensor cores
}
WEIGHT_BYTES = {"fp32": 4, "bf16": 2}
POS = 3                              # position columns of a node's features


def conv_flops(ns: int, nd: int, edges: float, f_src: int, f_dst: int,
               gates: int, channels: int) -> float:
    """FLOPs of one fused-gate conv of nd destination rows over ns source
    rows and `edges` live edges."""
    gc = gates * channels
    flops = 2 * ns * f_src * gc * 2            # key, value (per source row)
    flops += 2 * nd * f_dst * gc * 2           # query, skip
    flops += 2 * nd * POS * gc * 2             # position products
    flops += 2 * edges * POS * gc * 2          # per-edge shift products
    flops += 2 * edges * gc * channels         # l2, block-diagonal
    flops += edges * gc * 3                    # logits product, sum, alpha
    flops += edges * gates * 6                 # softmax
    return float(flops)


def conv_bytes(ns: int, nd: int, k: int, f_src: int, f_dst: int,
               gates: int, channels: int, precision: str) -> float:
    """Bytes of one conv: its inputs read once, its output written once."""
    gc = gates * channels
    w = WEIGHT_BYTES[precision]
    inputs = (ns * f_src + nd * f_dst) * 4     # x_src, x_dst (float32)
    inputs += nd * k * (4 + 4 + 4)             # nbr (int32), length, mask
    weights = (2 * f_src * gc + 2 * f_dst * gc    # key, value; query, skip
               + 4 * gc                           # their biases
               + gates * channels * channels      # l2
               + gc                               # l2 bias
               + gc)                              # edge weight
    return float(inputs + weights * w + nd * gc * 4)


def conv_least_s(ns, nd, k, edges, f_src, f_dst, gates, channels,
                 precision: str) -> float:
    """The least time the chip could take for one conv: the larger of its
    FLOPs over the precision's peak and its bytes over the HBM's."""
    return max(conv_flops(ns, nd, edges, f_src, f_dst, gates, channels)
               / PEAK_FLOPS[precision],
               conv_bytes(ns, nd, k, f_src, f_dst, gates, channels,
                          precision) / PEAK_BYTES)
