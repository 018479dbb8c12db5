"""Where the port's hand kernels spend their time on the card, beyond what
chip_smoke.py reports: the node projections at the connect shape split
into their parts, by timing builds of csrc/edge_stage.cu with a part left
out (-DNODE_PROJ_PART: 1 without the products, 2 without the tile loads
and stores); the edge kernel at the 120 um rollout's three conv shapes
(first span, real masks) by gather and product warps per block (-DEA_GW,
-DEA_PW) and by part (-DEDGE_ATTN_PART: 1 without the l2 product, 2
the staging of Wl2 and the product alone); and the topology editor's
device time on the first span's inputs as a function of max_switch (the
number of switches it runs), for three thread counts per block.

    python3 scripts/torch_kernel_probe.py      # one CUDA card

Prints one JSON line per measurement, the card's name and power limit
first. Times come from chip_smoke.cuda_ms (calls replayed from a CUDA
graph between two CUDA events).
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage, editor_fused  # noqa: E402
from graingraphnn_torch.models import cells  # noqa: E402
from graingraphnn_torch.ops import period_conv  # noqa: E402
from graingraphnn_torch.rollout import device_driver as dd  # noqa: E402
from graingraphnn_torch.rollout import device_rollout as dr  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402

NODE_PROJ_PARTS = {"full": 0, "no_products": 1, "products_only": 2}
EDGE_ATTN_VARIANTS = {
    "default": (),
    **{f"gather{g}_product{p}": (f"-DEA_GW={g}", f"-DEA_PW={p}")
       for g, p in ((12, 8), (20, 8), (16, 4), (22, 8))},
    "no_product": ("-DEDGE_ATTN_PART=1",),
    "product_only": ("-DEDGE_ATTN_PART=2",),
}
EDITOR_THREADS = (256, 512, 1024)


def node_proj_parts():
    """Device time of the grouped node projections at the connect shape,
    whole and with parts left out."""
    flags = {name: edge_stage.NVCC_FLAGS + (f"-DNODE_PROJ_PART={part}",)
             for name, part in NODE_PROJ_PARTS.items()}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    conv = period_conv.PeriodConv(104, 104, 96, 4)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    conv = conv.to(dev)
    xs = torch.rand(2086, 104, device=dev)
    xd = torch.rand(2086, 104, device=dev)
    for name in NODE_PROJ_PARTS:
        fn = _build.function(edge_stage.SOURCE, "edge_node_proj",
                             edge_stage._PROJ_ARGTYPES, flags[name])
        ms = cs.cuda_ms(lambda: edge_stage.launch_node_proj(
            fn, torch.cuda.current_stream().cuda_stream, conv, xs, xd))
        print(json.dumps({"probe": "node_proj", "shape": "connect",
                          "variant": name, "ms": ms}), flush=True)


def edge_attn_variants(reg, state):
    """Device time of the edge kernel at the rollout's three conv shapes
    (the decoder's inputs on the first span) for each build in
    EDGE_ATTN_VARIANTS; max abs error against the plain version for the
    builds that compute the whole kernel."""
    sample, _ = dr.make_sample(state)
    G, C = cells.NUM_GATES, reg.hp.layer_size
    for shape, (conv, xs, xd, nbr, ln, m) in cs.decoder_conv_inputs(
            reg, sample).items():
        proj = period_conv.node_projections_plain(conv, xs, xd)
        ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, m, proj,
                                          num_gates=G, out_channels=C)
        for name, flags in EDGE_ATTN_VARIANTS.items():
            fn = _build.function(edge_stage.SOURCE, "edge_attn_forward",
                                 edge_stage._ATTN_ARGTYPES,
                                 edge_stage.NVCC_FLAGS + flags)

            def call():      # on the stream a graph capture runs on
                return edge_stage.launch_edge_attn(
                    fn, torch.cuda.current_stream().cuda_stream, conv, xs, xd,
                    nbr, ln, m, proj, G, C)

            err = None
            if "PART" not in " ".join(flags):
                err = (call() - ref).abs().max().item()
            print(json.dumps({"probe": "edge_attn", "shape": shape,
                              "variant": name, "ms": cs.cuda_ms(call),
                              "max_abs_err": err}), flush=True)


def editor_by_switches(reg, cls, state):
    """Device time of the editor on the first span's inputs by max_switch
    and threads per block."""
    ts, logits, ge, yg = cs.editor_inputs(reg, cls, state)
    NG = state.xg.shape[0]
    prob = torch.sigmoid(logits)
    E = ts.E_pp
    n_cand = int(((prob > cs.C_THRESHOLD) & (E[0] < E[1]) & (E[0] >= 0)).sum())
    print(json.dumps({"probe": "editor_candidates", "n": n_cand,
                      "p_eq_1": int((prob == 1.0).sum())}), flush=True)
    flags = {t: editor_fused.NVCC_FLAGS + (f"-DEDITOR_THREADS={t}",)
             for t in EDITOR_THREADS}
    for t in EDITOR_THREADS:
        fn = _build.function(editor_fused.SOURCE, "editor_update",
                             editor_fused._ARGTYPES, flags[t])
        for ms_ in (0, 1, 4, 12, 24):
            ms = cs.cuda_ms(lambda: editor_fused.launch(
                fn, torch.cuda.current_stream().cuda_stream, ts, prob, ge, yg,
                cs.C_THRESHOLD, NG, ms_), n=10)
            print(json.dumps({"probe": "editor", "threads": t,
                              "max_switch": ms_, "ms": ms}), flush=True)


@torch.no_grad()    # the kernels have no backward
def main():
    cs.phase_device()
    _build.build(
        [(edge_stage.SOURCE, edge_stage.NVCC_FLAGS + (f"-DNODE_PROJ_PART={p}",))
         for p in NODE_PROJ_PARTS.values()]
        + [(edge_stage.SOURCE, edge_stage.NVCC_FLAGS + f)
           for f in EDGE_ATTN_VARIANTS.values()]
        + [(editor_fused.SOURCE, editor_fused.NVCC_FLAGS
            + (f"-DEDITOR_THREADS={t}",)) for t in EDITOR_THREADS])
    print(json.dumps({"build": _build.build_log}), flush=True)
    node_proj_parts()
    cuda = torch.device("cuda")
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", cuda)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", cuda)
    x, edges, mask, lxd, patch = dd.load_fixture()
    state, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device=cuda)
    edge_attn_variants(reg, state)
    editor_by_switches(reg, cls, state)


if __name__ == "__main__":
    main()
