"""Plain reference of ``criteo_ftrl``: FTRL-proximal logistic regression
(McMahan et al. 2013; the reference's sgd_server_handle.h:111-141) over
crec2 blocks, one step a block, in float64.

State per bucket [w, z, n] with n = sqrt(sum g^2), all zero at the start.
A step: margin_r = sum over the row's pairs of w_bucket (bfloat16 at tile
pairs, as the configuration states); dual_r = d loss / d margin; g_b = sum
over the bucket's pairs of dual_row (bfloat16 at tile pairs); then, for
every bucket, n' = sqrt(n^2 + g^2), sigma = (n' - n)/alpha, z' = z + g -
sigma*w, w' = -sign(z') max(|z'| - l1, 0) / ((beta + n')/alpha + l2). A
bucket no pair reached has g = 0 and keeps its state (w is already the
same function of z and n), so the step updates the block's buckets alone.
"""

from __future__ import annotations

import torch

from portbench.reference.common import Block, Rounding, logit, margin_hist

GRAD_LEAVES = ("g",)
CHANGE_LEAVES = {"w": "g", "z": "g", "n": "g"}


class FTRL:
    def __init__(self, cfg: dict, device, seed: int,
                 rounding: Rounding = Rounding()):
        self.alpha = float(cfg["lr_eta"])
        self.beta = float(cfg["lr_beta"])
        self.l1, self.l2 = (float(v) for v in cfg["lambda"])
        nb = int(cfg["data"]["num_buckets"])
        self.rd = rounding
        z = torch.zeros(nb, dtype=torch.float64, device=device)
        self.state = {"w": z.clone(), "z": z.clone(), "n": z.clone()}

    def leaves(self) -> dict:
        return {k: v.clone() for k, v in self.state.items()}

    def step(self, blk: Block) -> dict:
        rd = self.rd
        w, z, n = self.state["w"], self.state["z"], self.state["n"]
        wp = rd.tile_pairs(w[blk.b], blk.spill)
        m = rd.stage(torch.zeros(blk.rows, dtype=torch.float64,
                                 device=w.device).index_add_(0, blk.r, wp))
        objv, dual = logit(m, blk.y, blk.weight)
        dual = rd.stage(dual)
        dp = rd.tile_pairs(dual[blk.r], blk.spill)
        u = blk.u
        g = rd.stage(torch.zeros(u.shape[0], dtype=torch.float64,
                                 device=w.device).index_add_(0, blk.inv, dp))
        nu, wu = n[u], w[u]
        n2 = torch.sqrt(nu * nu + g * g)
        sigma = (n2 - nu) / self.alpha
        z2 = z[u] + g - sigma * wu
        w2 = (torch.sign(-z2) * torch.clamp(z2.abs() - self.l1, min=0.0)
              / ((self.beta + n2) / self.alpha + self.l2))
        w[u], z[u], n[u] = rd.stage(w2), rd.stage(z2), rd.stage(n2)
        pos, neg = margin_hist(m, blk.y)
        return {"objv": float(objv), "grads": {"g": g}, "pos": pos,
                "neg": neg}


Reference = FTRL
