"""GrainNN regressor and classifier.

Each model runs an encoder stack from the zero state, then a decoder stack
that re-reads the same input warm-started with the encoder state, then its
heads. A stack is one fused HeteroPGCLSTM cell (models/cells.py) followed
by `layers - 1` SAGE cells; with the shipped configs (one layer) a forward
runs six conv applications. The regressor's optional `history` branch
concatenates a temporal LSTM over past gradients to the graph state, and
its optional `edge_len` head predicts each jj edge's length change.

Parameter names follow the JAX package's tree, so `encoder.0.conv.push.key.w`
here is `params["encoder"][0]["conv"]["push"]["key"]["w"]` there. The
forwards take `kernels`, the conv formulation (ops.period_conv): True for
the hand kernels on the card (no autograd), False for the torch
formulation that training differentiates; and `precision`, "fp32" (the
default) or "bf16" (JAX's pallas=True forwards with kernels).

Initialisation draws from an explicit torch.Generator with the JAX
package's distributions (Glorot convs, torch-Linear heads and SAGE convs,
torch-LSTM history); JAX's random streams cannot be matched, so values
differ.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..graph import schema
from ..graph.state import GraphSample
from ..ops.period_conv import Dense
from . import cells, lstm
from .hyper import HyperParams

HISTORY_DIMS = {"joint": 2, "grain": 1}


def _stack(hp: HyperParams) -> nn.ModuleList:
    C = hp.layer_size
    return nn.ModuleList([
        cells.PGCLSTM(hp.in_grain, hp.in_joint, C) if kind == "pgclstm"
        else cells.SageCLSTM(C, C, C) for kind in hp.cell_kinds])


def _init_stack(stack: nn.ModuleList, hp: HyperParams, gen):
    for cell, kind in zip(stack, hp.cell_kinds):
        if kind == "pgclstm":
            cells.init_pgclstm(cell, gen)
        else:
            cells.init_sage_clstm(cell, gen)


def _pair(hj: torch.Tensor, sample: GraphSample) -> torch.Tensor:
    """[h_src, h_dst, length] per directed jj edge; hj is the table the
    sample's jj indices point into."""
    return torch.cat([hj.index_select(0, sample.jj_src.long()),
                      hj.index_select(0, sample.jj_dst.long()),
                      sample.jj_len[:, None]], dim=1)


class _EncoderDecoder(nn.Module):
    def __init__(self, hp: HyperParams):
        super().__init__()
        self.hp = hp
        self.encoder = _stack(hp)
        self.decoder = _stack(hp)

    def _apply_stack(self, stack, sample, states, kernels, src_gather,
                     precision):
        C = self.hp.layer_size
        if states is None:
            states = [cells.zero_state(sample, C) for _ in stack]
        new_states = []
        g_in, j_in = sample.grain_x, sample.joint_x
        for cell, kind, st in zip(stack, self.hp.cell_kinds, states):
            h, c = cells.apply_cell(cell, sample, g_in, j_in, st, C,
                                    kind=kind, kernels=kernels,
                                    src_gather=src_gather,
                                    precision=precision)
            new_states.append((h, c))
            g_in, j_in = h["grain"], h["joint"]
        return new_states

    def encode_decode(self, sample: GraphSample, *, kernels: bool,
                      src_gather=None, precision: str = "fp32"
                      ) -> Dict[str, torch.Tensor]:
        enc = self._apply_stack(self.encoder, sample, None, kernels,
                                src_gather, precision)
        h, _c = self._apply_stack(self.decoder, sample, enc, kernels,
                                  src_gather, precision)[-1]
        return h


class Regressor(_EncoderDecoder):
    def __init__(self, hp: HyperParams):
        super().__init__(hp)
        C = hp.layer_size
        head_in = 2 * C if hp.history else C
        self.head = nn.ModuleDict({
            "grain": Dense((head_in, hp.n_grain_targets), (hp.n_grain_targets,)),
            "joint": Dense((head_in, hp.n_joint_targets), (hp.n_joint_targets,)),
        })
        if hp.history:
            self.lstm = nn.ModuleDict({
                k: lstm.LSTM(HISTORY_DIMS[k], C) for k in ("grain", "joint")})
        if hp.edge_len:
            # sized to its input [h_src, h_dst, length], as in the JAX package
            self.lin1 = Dense((2 * head_in + 1, 1), (1,))

    def forward(self, sample: GraphSample, *, kernels: bool,
                src_gather=None, node_gather=None, precision: str = "fp32"
                ) -> Dict[str, torch.Tensor]:
        """Returns 'joint' [NJ, 2] tanh(dx, dy), 'grain' [NG, 2] (tanh
        darea, relu extraV), 'grain_area' [NG], the predicted area, and with
        edge_len 'edge' [E], the tanh length change.

        Where node rows are split over ranks (parallel.halo), src_gather(xg,
        xj) makes the convs' source tables and node_gather(hj) the table the
        jj indices point into; None on one device."""
        h = self.encode_decode(sample, kernels=kernels,
                               src_gather=src_gather, precision=precision)
        hg, hj = h["grain"], h["joint"]
        if self.hp.history:
            w = self.hp.window
            hg = torch.cat([hg, self.lstm["grain"](lstm.history_inputs(
                sample.grain_x, HISTORY_DIMS["grain"], w))], dim=1)
            hj = torch.cat([hj, self.lstm["joint"](lstm.history_inputs(
                sample.joint_x, HISTORY_DIMS["joint"], w))], dim=1)
        hd = self.head
        y_joint = torch.tanh(hj @ hd["joint"].w + hd["joint"].b)
        y_grain_raw = hg @ hd["grain"].w + hd["grain"].b
        darea = torch.tanh(y_grain_raw[:, 0])
        extrav = torch.relu(y_grain_raw[:, 1])
        area = (darea / schema.TARGET_SCALING["grain"]
                + sample.grain_x[:, schema.GRAIN_AREA_COL])
        out = {
            "joint": y_joint,
            "grain": torch.stack([darea, extrav], dim=1),
            "grain_area": area,
        }
        if self.hp.edge_len:
            hj_full = hj if node_gather is None else node_gather(hj)
            out["edge"] = torch.tanh(
                _pair(hj_full, sample) @ self.lin1.w + self.lin1.b)[:, 0]
        return out


class Classifier(_EncoderDecoder):
    def __init__(self, hp: HyperParams):
        super().__init__(hp)
        # the JAX package sizes the heads 3C + 1 with history, though its
        # pair feature stays 2C + 1
        head_in = (3 if hp.history else 2) * hp.layer_size + 1
        self.lin1 = Dense((head_in, 2), (2,))   # length prediction
        self.lin2 = Dense((head_in, 1), (1,))   # event logit

    def forward(self, sample: GraphSample, *, kernels: bool,
                src_gather=None, node_gather=None, precision: str = "fp32"
                ) -> Dict[str, torch.Tensor]:
        """Returns 'edge_event' [E] raw logits per directed jj edge and
        'edge' [E, 2] tanh length prediction. src_gather and node_gather
        as in Regressor.forward."""
        hj = self.encode_decode(sample, kernels=kernels,
                                src_gather=src_gather,
                                precision=precision)["joint"]
        pair = _pair(hj if node_gather is None else node_gather(hj), sample)
        logits = (pair @ self.lin2.w + self.lin2.b)[:, 0]
        edge = torch.tanh(pair @ self.lin1.w + self.lin1.b)
        return {"edge_event": logits, "edge": edge}


def build(hp: HyperParams) -> nn.Module:
    """The model the config names, with zero weights (initialise them with
    init_regressor / init_classifier, or load them with
    train.checkpoint.params_from_jax)."""
    kinds = {"regressor": Regressor, "classifier": Classifier}
    if hp.model_type not in kinds:
        raise ValueError(f"model_type {hp.model_type!r}")
    return kinds[hp.model_type](hp)


def init_regressor(hp: HyperParams, generator: torch.Generator) -> Regressor:
    """A regressor with fresh weights on the CPU: Glorot convs with zero
    biases, torch-Linear heads, torch-LSTM history branch."""
    model = Regressor(hp)
    _init_stack(model.encoder, hp, generator)
    _init_stack(model.decoder, hp, generator)
    for k in ("grain", "joint"):
        cells.torch_linear_init(model.head[k], generator)
    if hp.history:
        for k in ("grain", "joint"):
            lstm.init_lstm(model.lstm[k], generator)
    if hp.edge_len:
        cells.torch_linear_init(model.lin1, generator)
    return model


def init_classifier(hp: HyperParams, generator: torch.Generator,
                    regressor: Optional[nn.Module] = None) -> Classifier:
    """A classifier with fresh weights on the CPU; with `regressor`, its
    encoder and decoder are copies of the regressor's (transfer learning)."""
    model = Classifier(hp)
    if regressor is not None:
        for name in ("encoder", "decoder"):
            getattr(model, name).load_state_dict(
                getattr(regressor, name).state_dict())
    else:
        _init_stack(model.encoder, hp, generator)
        _init_stack(model.decoder, hp, generator)
    cells.torch_linear_init(model.lin1, generator)
    cells.torch_linear_init(model.lin2, generator)
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
