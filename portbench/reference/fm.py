"""Plain reference of ``criteo_fm``: a factorization machine (Rendle 2010)
of dim k over crec2 blocks, trained with AdaGrad, one step a block, in
float64.

Each bucket holds [w, v_1..v_k, cg_w, cg_v1..cg_vk]; v starts at
init_scale * N(0, 1) from ``numpy.random.default_rng(seed)`` drawn as one
(num_buckets, k) array and stored in float32, everything else at zero. A
step: each row pulls the channels [w, v_1..v_k, sum_c v_c^2] of its pairs
(bfloat16 at tile pairs, as the configuration states) into lin, s_c and q;
margin = lin + (sum_c s_c^2 - q)/2; the row pushes [dual, dual*s_1..dual*s_k,
1] to its pairs' buckets (bfloat16 at tile pairs). On every bucket a push
reached: g_w = push_dual, g_v = push_s - v*g_w + l2_v*v; cg' = sqrt(cg^2 +
g^2); eta = alpha/(beta + cg'); w' = prox_{l1,l2}(w - eta*g_w); v' = v -
eta*g_v. The other buckets keep their state.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import Block, Rounding, logit, margin_hist

GRAD_LEAVES = ("g_w", "g_v")
CHANGE_LEAVES = {"w": "g_w", "v": "g_v", "cg_w": "g_w", "cg_v": "g_v"}


def init_v(nb: int, k: int, scale: float, seed: int) -> np.ndarray:
    """The seeded factor draw, in float32."""
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((nb, k))).astype(np.float32)


class FM:
    def __init__(self, cfg: dict, device, seed: int,
                 rounding: Rounding = Rounding()):
        m = cfg["model"]
        self.k = k = int(m["dim"])
        self.alpha, self.beta = float(m["lr_alpha"]), float(m["lr_beta"])
        self.l1, self.l2 = float(m["l1"]), float(m["l2"])
        self.l2_v = float(m["l2_v"])
        nb = int(cfg["data"]["num_buckets"])
        self.rd = rounding
        v = torch.from_numpy(init_v(nb, k, float(m["init_scale"]), seed))
        z = torch.zeros(nb, dtype=torch.float64, device=device)
        self.state = {"w": z.clone(),
                      "v": rounding.stage(v.to(device=device,
                                               dtype=torch.float64)),
                      "cg_w": z.clone(),
                      "cg_v": torch.zeros((nb, k), dtype=torch.float64,
                                          device=device)}

    def leaves(self) -> dict:
        return {k: v.clone() for k, v in self.state.items()}

    def step(self, blk: Block) -> dict:
        rd, k = self.rd, self.k
        st = self.state
        u = blk.u
        w, v, cgw, cgv = st["w"][u], st["v"][u], st["cg_w"][u], st["cg_v"][u]
        dev = w.device
        pull = rd.stage(torch.cat([w[:, None], v,
                                   torch.sum(v * v, 1, keepdim=True)], 1))
        pp = rd.tile_pairs(pull[blk.inv], blk.spill)
        pulls = rd.stage(torch.zeros((blk.rows, k + 2), dtype=torch.float64,
                                     device=dev).index_add_(0, blk.r, pp))
        lin, s, q = pulls[:, 0], pulls[:, 1:1 + k], pulls[:, 1 + k]
        m = rd.stage(lin + 0.5 * (torch.sum(s * s, 1) - q))
        objv, dual = logit(m, blk.y, blk.weight)
        row = rd.stage(torch.cat([dual[:, None], dual[:, None] * s,
                                  torch.ones_like(dual)[:, None]], 1))
        rp = rd.tile_pairs(row[blk.r], blk.spill)
        push = rd.stage(torch.zeros((u.shape[0], k + 2), dtype=torch.float64,
                                    device=dev).index_add_(0, blk.inv, rp))
        g_w = push[:, 0]
        g_v = push[:, 1:1 + k] - v * g_w[:, None] + self.l2_v * v
        cgw2 = torch.sqrt(cgw * cgw + g_w * g_w)
        cgv2 = torch.sqrt(cgv * cgv + g_v * g_v)
        eta_w = self.alpha / (self.beta + cgw2)
        eta_v = self.alpha / (self.beta + cgv2)
        zz = w / eta_w - g_w
        w2 = (torch.sign(zz) * torch.clamp(zz.abs() - self.l1, min=0.0)
              / (1.0 / eta_w + self.l2))
        st["w"][u] = rd.stage(w2)
        st["v"][u] = rd.stage(v - eta_v * g_v)
        st["cg_w"][u] = rd.stage(cgw2)
        st["cg_v"][u] = rd.stage(cgv2)
        pos, neg = margin_hist(m, blk.y)
        return {"objv": float(objv), "grads": {"g_w": g_w, "g_v": g_v},
                "pos": pos, "neg": neg}


Reference = FM
