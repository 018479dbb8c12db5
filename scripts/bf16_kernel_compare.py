"""The bf16 edge kernels of this checkout against those of another checkout
(an earlier commit unpacked with `git archive`), on one card, in turns.

    python3 scripts/bf16_kernel_compare.py --other DIR [--repeats 2]

DIR is the root of the other checkout. Its
graingraphnn_torch/csrc/edge_stage_bf16.cu is built here with nvcc and
bound, and its kernels launched, through its own
graingraphnn_torch/kernels/edge_stage.py, so the two sources may differ
in their argument lists: ARGTYPES["bf16"] and the launchers at precision
"bf16" (the weights as its own pack_bf16 lays them out), or, in a
checkout from before the weight pack, its fp32 argument lists and
launchers (the bf16 kernels then took the fp32 weights). At the decoder
convs (push, connect, pull) of the 40, 120 and 240 um graphs, with the
shipped 40 um regressor, each kernel of each source is checked against its
plain bf16 version (chip_smoke.close_bf16) and timed with chip_smoke.cuda_ms in
the order other, this, this, other (`--repeats` rounds). Prints the
card's name and power limit, then one JSON line per conv, with each
kernel's ptxas lines.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage  # noqa: E402
from graingraphnn_torch.rollout import device_driver as dd  # noqa: E402
from graingraphnn_torch.rollout import device_rollout as dr  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402

GRAPHS = {40: (3, 4.0, 1.0), 240: (cs.R240["seed"], cs.R240["G"],
                                   cs.R240["R"])}


def binding(mod):
    """The other edge_stage module's bf16 argument lists by entry and its
    node_proj and edge_attn launchers, called as this module's are."""
    if hasattr(mod, "ARGTYPES"):
        return (mod.ARGTYPES["bf16"],
                lambda *a: mod.launch_node_proj(*a, "bf16"),
                lambda *a: mod.launch_edge_attn(*a, "bf16"))
    return ({"conv": mod._ARGTYPES, "node_proj": mod._PROJ_ARGTYPES,
             "edge_attn": mod._ATTN_ARGTYPES},
            mod.launch_node_proj, mod.launch_edge_attn)


def build_other(root):
    """The other checkout's node_proj and edge_attn launchers, its bf16
    source as a ctypes library with the entries bound by its own argument
    lists, and the source's ptxas lines."""
    path = os.path.join(root, "graingraphnn_torch", "kernels", "edge_stage.py")
    spec = importlib.util.spec_from_file_location(
        "graingraphnn_torch.kernels._other_edge_stage", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argtypes, *launchers = binding(mod)
    src = os.path.join(root, "graingraphnn_torch", "csrc", "edge_stage_bf16.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libother_edge_stage_bf16-{tag}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(out)
    err_string = lib.ggnn_error_string
    err_string.argtypes, err_string.restype = [ctypes.c_int], ctypes.c_char_p
    fns = {}
    for which, sym in mod.ENTRIES["bf16"][1].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes[which]
        fn.restype = ctypes.c_int

        def call(*a, fn=fn, sym=sym):
            err = fn(*a)
            if err:
                raise RuntimeError(f"other {sym}: {err_string(err).decode()}")

        fns[which] = call
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "ptxas" in ln and ("registers" in ln or "spill" in ln
                                   or "Compiling" in ln)]
    return launchers, fns, ptxas


def conv_inputs(reg, dev):
    """{lxd: decoder conv inputs} at the first span of each graph."""
    out = {}
    x, edges, mask, lxd, patch = dd.load_fixture()
    states = {120: dd.init_scaled_state(x, edges, mask, lxd, patch,
                                        device=dev)[0]}
    for lxd, (seed, G, R) in GRAPHS.items():
        t = dd.generate_trajectory(lxd, seed, G, R)
        states[lxd] = dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                           t.patch_size, device=dev)[0]
    for lxd in sorted(states):
        sample, _ = dr.make_sample(states[lxd])
        out[lxd] = cs.decoder_conv_inputs(reg, sample, "bf16")
    return out


def compare(launchers, other, inputs, C, repeats):
    G = 4
    other_np, other_ea = launchers
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for lxd, convs in inputs.items():
        for name, (conv, xs, xd, nbr, ln, m) in convs.items():
            proj = edge_stage.node_proj_cuda(conv, xs, xd, "bf16")
            ref_p = cs.period_conv.node_projections_plain(conv, xs, xd,
                                                          "bf16")
            ref = cs.period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, m,
                                                 ref_p, **kw)
            calls = {
                ("node_proj", "other"): lambda: other_np(
                    other["node_proj"], stream(), conv, xs, xd),
                ("node_proj", "this"): lambda: edge_stage.node_proj_cuda(
                    conv, xs, xd, "bf16"),
                ("edge_attn", "other"): lambda: other_ea(
                    other["edge_attn"], stream(), conv, xs, xd, nbr, ln, m,
                    ref_p, G, C),
                ("edge_attn", "this"): lambda: edge_stage.edge_attn_cuda(
                    conv, xs, xd, nbr, ln, m, ref_p, **kw),
            }
            err = {}
            for (kernel, who), fn in calls.items():
                out = fn()
                if kernel == "node_proj":
                    err[f"{kernel}_{who}"] = max(
                        cs.close(f"{kernel} {who}", o, r)[0]
                        for o, r in zip(out, ref_p))
                else:
                    err[f"{kernel}_{who}"] = cs.close_bf16(
                        f"{kernel} {who}", out, ref)
            ms = {f"{k}_{w}": [] for k, w in calls}
            for _ in range(repeats):
                for kernel in ("node_proj", "edge_attn"):
                    for who in ("other", "this", "this", "other"):
                        ms[f"{kernel}_{who}"].append(
                            cs.cuda_ms(calls[(kernel, who)]))
            print(json.dumps(dict(
                lxd=lxd, conv=name, K=nbr.shape[1], Ns=xs.shape[0],
                Nd=xd.shape[0], F_src=xs.shape[1], F_dst=xd.shape[1],
                err=err, ms=ms, ms_min={k: min(v) for k, v in ms.items()})),
                flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    _, smi = cs.phase_device()
    dev = torch.device("cuda")
    log = _build.build([(edge_stage.SOURCE_BF16, edge_stage.NVCC_FLAGS)])
    launchers, other, other_ptxas = build_other(args.other)
    print(json.dumps({"ptxas_this": [v["ptxas"] for v in log.values()],
                      "ptxas_other": other_ptxas}), flush=True)
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    with torch.no_grad():
        compare(launchers, other, conv_inputs(reg, dev), reg.hp.layer_size,
                args.repeats)


if __name__ == "__main__":
    main()
