"""The plain float32 reference of the training step: loss, gradients, AdamW.

It follows the program's first steps from the same weights (drawn again
from the seed) and the same batches, in float32 with TF32 off, a layer at
a time:

- the forward keeps each layer's input; the backward runs the layers in
  reverse, each recomputed under autograd from its input;
- the optimizer is optax's chain as the configuration states it:
  clip_by_global_norm, then AdamW (b1, b2, eps 1e-8, weight decay on every
  leaf) at a warmup-cosine learning rate whose count starts at 0.

To fit one card it keeps no weights and no moments: the weights after a
step are worked out leaf by leaf from the seed's weights and the stored
float32 gradients of the steps before. So it follows two steps (two
gradients held) and reads the loss of the third: ``follow`` returns the
three losses, every leaf's gradient norm as the optimizer gets it (after
the clip) in step 1, and every leaf's change after two steps.

``quant`` (the control) rounds every matmul's operands; ``weights`` (a
(B, S) mask) leaves tokens out of the mean (a planted fault).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import weights as W
from ..model_config import Sizes
from . import model as M

Key = Tuple[str, int]
EPS = 1e-8


def schedule(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay)(count)."""
    lr, warm = float(opt["learning_rate"]), int(opt["warmup_steps"])
    decay = max(int(opt["decay_steps"]), warm + 1)
    if count < warm:
        return lr * count / warm
    t = min(count - warm, decay - warm)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))


class Follow:
    def __init__(self, s: Sizes, seed: int, device, opt: dict,
                 quant: M.Quant = None):
        self.s, self.seed, self.dev, self.opt = s, seed, device, opt
        self.quant = quant
        self.grads: List[Dict[Key, torch.Tensor]] = []   # per step, f32
        self.clips: List[float] = []

    # -- the weights after the steps taken so far, one leaf at a time --
    def p0(self, key: Key) -> torch.Tensor:
        return W.draw(self.s, self.seed, key[0], key[1], self.dev,
                      torch.float32)

    def param(self, key: Key, steps: Optional[int] = None) -> torch.Tensor:
        """The leaf after ``steps`` (default: every step taken) updates."""
        o = self.opt
        b1, b2, wd = float(o["b1"]), float(o["b2"]), float(o["weight_decay"])
        p = self.p0(key)
        mu = torch.zeros_like(p)
        nu = torch.zeros_like(p)
        n = len(self.grads) if steps is None else steps
        for k in range(n):
            g = self.grads[k][key] * self.clips[k]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            c = k + 1
            u = (mu / (1 - b1 ** c)) / ((nu / (1 - b2 ** c)).sqrt() + EPS)
            p = p - schedule(o, k) * (u + wd * p)
        return p

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        return {k: self.param((k, li)) for k in W.MATMUL + W.NORMS}

    # -- one pass over a batch --
    def loss_and_grads(self, tokens: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       want_grads: bool = True):
        """tokens (B, S + 1): the loss (mean next-token cross-entropy over
        the tokens ``mask`` keeps), and, if asked, every leaf's f32
        gradient."""
        s, q = self.s, self.quant
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        B, S = inputs.shape
        keep = (torch.ones(B, S, device=self.dev) if mask is None
                else mask.float())
        cos, sin = M.rope(s, torch.arange(S, device=self.dev))
        grads: Dict[Key, torch.Tensor] = {}
        with torch.no_grad():
            x = self.param(("embed", -1))[inputs]
            xs = [x]
            for li in range(s.layers):
                x = M.layer_forward(s, self.layer(li), x, cos, sin, q)
                xs.append(x)
        with torch.enable_grad():
            xl = xs[-1].requires_grad_(want_grads)
            ln_f = self.param(("ln_f", -1)).requires_grad_(want_grads)
            lm = self.param(("lm_head", -1)).requires_grad_(want_grads)
            logits = M.head(s, ln_f, lm, xl, q)
            nll = -F.log_softmax(logits, -1).gather(
                -1, targets[..., None])[..., 0]
            loss = (nll * keep).sum() / keep.sum()
            if not want_grads:
                return float(loss.detach()), grads
            loss.backward()
        del logits, nll
        grads[("ln_f", -1)], grads[("lm_head", -1)] = ln_f.grad, lm.grad
        dx = xl.grad
        xs[-1] = None
        for li in reversed(range(s.layers)):
            w = {k: v.requires_grad_() for k, v in self.layer(li).items()}
            xin = xs[li].requires_grad_()
            with torch.enable_grad():
                out = M.layer_forward(s, w, xin, cos, sin, q)
                out.backward(dx)
            for k, v in w.items():
                grads[(k, li)] = v.grad
            dx = xin.grad
            xs[li] = None
            del out, w
        ge = torch.zeros(s.vocab, s.hidden, device=self.dev)
        ge.index_add_(0, inputs.reshape(-1), dx.reshape(-1, s.hidden))
        grads[("embed", -1)] = ge
        return float(loss.detach()), grads

    def step(self, tokens, mask=None) -> float:
        """Take one step: the loss at the current weights; the gradient is
        kept, with its clip factor."""
        loss, g = self.loss_and_grads(tokens, mask)
        norm = math.sqrt(sum(float(t.double().square().sum())
                             for t in g.values()))
        clip = float(self.opt["grad_clip"])
        self.clips.append(1.0 if norm < clip else clip / norm)
        self.grads.append(g)
        return loss

    def follow(self, batches, masks=None) -> dict:
        """Two steps and the third step's loss. Returns ``loss`` (3),
        ``grad`` {leaf: norm of step 1's clipped gradient} and ``change``
        {leaf: norm of the change after two steps}."""
        masks = masks or [None] * 3
        losses = [self.step(batches[0], masks[0]),
                  self.step(batches[1], masks[1])]
        grad = {k: float(v.norm()) * self.clips[0]
                for k, v in self.grads[0].items()}
        change = {k: float((self.param(k) - self.p0(k)).norm())
                  for k in self.grads[0]}
        losses.append(self.loss_and_grads(batches[2], masks[2],
                                          want_grads=False)[0])
        self.grads = []
        return {"loss": losses, "grad": grad, "change": change}


def _worst(prog: Dict[Key, float], ref: Dict[Key, float],
           keys) -> float:
    """The worst leaf's gap between two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    vals = sorted(ref[k] for k in keys)
    med = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers the training check compares: the widest relative gap of
    the three losses, and the worst leaf of the first gradient's and of
    the change's norms. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    keys = sorted(ref["grad"])
    g = sorted(ref["grad"][k] for k in keys)
    med = g[len(g) // 2]
    moving = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["grad"], ref["grad"], keys),
            "change_gap": _worst(prog["change"], ref["change"], moving)}
