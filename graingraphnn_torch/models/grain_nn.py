"""GrainNN regressor and classifier.

Each model runs an encoder cell from the zero state, then a decoder cell
that re-reads the same input warm-started with the encoder state, then its
heads. With the shipped configs each stack is one fused HeteroPGCLSTM cell
(models/cells.py), so a forward runs six conv applications.

Parameter names follow the JAX package's tree, so `encoder.0.conv.push.key.w`
here is `params["encoder"][0]["conv"]["push"]["key"]["w"]` there.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..graph import schema
from ..graph.state import GraphSample
from ..ops.period_conv import Dense
from . import cells
from .hyper import HyperParams


def _check_supported(hp: HyperParams):
    if hp.layers != 1:
        raise NotImplementedError("stacked SAGE cells (layers > 1)")
    if hp.history:
        raise NotImplementedError("history LSTM branch")
    if hp.edge_len:
        raise NotImplementedError("edge-length head")


class _EncoderDecoder(nn.Module):
    def __init__(self, hp: HyperParams):
        super().__init__()
        _check_supported(hp)
        self.hp = hp
        C = hp.layer_size
        self.encoder = nn.ModuleList(
            [cells.PGCLSTM(hp.in_grain, hp.in_joint, C)])
        self.decoder = nn.ModuleList(
            [cells.PGCLSTM(hp.in_grain, hp.in_joint, C)])

    def encode_decode(self, sample: GraphSample) -> Dict[str, torch.Tensor]:
        C = self.hp.layer_size
        enc = cells.apply_pgclstm(
            self.encoder[0], sample, sample.grain_x, sample.joint_x,
            cells.zero_state(sample, C), C)
        h, _c = cells.apply_pgclstm(
            self.decoder[0], sample, sample.grain_x, sample.joint_x, enc, C)
        return h


class Regressor(_EncoderDecoder):
    def __init__(self, hp: HyperParams):
        super().__init__(hp)
        C = hp.layer_size
        self.head = nn.ModuleDict({
            "grain": Dense((C, hp.n_grain_targets), (hp.n_grain_targets,)),
            "joint": Dense((C, hp.n_joint_targets), (hp.n_joint_targets,)),
        })

    def forward(self, sample: GraphSample) -> Dict[str, torch.Tensor]:
        """Returns 'joint' [NJ, 2] tanh(dx, dy), 'grain' [NG, 2] (tanh
        darea, relu extraV) and 'grain_area' [NG], the predicted area."""
        h = self.encode_decode(sample)
        hg, hj = h["grain"], h["joint"]
        hd = self.head
        y_joint = torch.tanh(hj @ hd["joint"].w + hd["joint"].b)
        y_grain_raw = hg @ hd["grain"].w + hd["grain"].b
        darea = torch.tanh(y_grain_raw[:, 0])
        extrav = torch.relu(y_grain_raw[:, 1])
        area = (darea / schema.TARGET_SCALING["grain"]
                + sample.grain_x[:, schema.GRAIN_AREA_COL])
        return {
            "joint": y_joint,
            "grain": torch.stack([darea, extrav], dim=1),
            "grain_area": area,
        }


class Classifier(_EncoderDecoder):
    def __init__(self, hp: HyperParams):
        super().__init__(hp)
        head_in = 2 * hp.layer_size + 1
        self.lin1 = Dense((head_in, 2), (2,))   # length prediction
        self.lin2 = Dense((head_in, 1), (1,))   # event logit

    def forward(self, sample: GraphSample) -> Dict[str, torch.Tensor]:
        """Returns 'edge_event' [E] raw logits per directed jj edge and
        'edge' [E, 2] tanh length prediction."""
        hj = self.encode_decode(sample)["joint"]
        pair = torch.cat([
            hj[sample.jj_src.long()], hj[sample.jj_dst.long()],
            sample.jj_len[:, None],
        ], dim=1)
        logits = (pair @ self.lin2.w + self.lin2.b)[:, 0]
        edge = torch.tanh(pair @ self.lin1.w + self.lin1.b)
        return {"edge_event": logits, "edge": edge}


def build(hp: HyperParams) -> nn.Module:
    """The model the config names, with zero weights (load them with
    train.checkpoint.params_from_jax)."""
    return {"regressor": Regressor, "classifier": Classifier}[hp.model_type](hp)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
