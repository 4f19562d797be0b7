"""Plain reference of a top-k mixture-of-experts decoder's training
steps (Mixtral's blocks): forward, backward by autograd, and AdamW, in
float32 with TF32 off.

What it follows, from the configuration: the dense decoder's attention
block (``reference/dense.py``); a router in float32, softmax over the
experts, the top ``k`` renormalized; a static capacity of
``int(capacity_factor * seq * k / experts)`` slots an expert a sequence,
filled in token order for the first choice of every token, then the
second, a token past it dropped for that choice; each kept (token,
choice) adding its gate times the expert's SwiGLU output; the Switch
load-balancing loss (``experts * sum(top-1 fraction * mean
probability)``, averaged over layers) times the router's aux weight,
added to the mean next-token cross-entropy. AdamW as the configuration
states it: the global norm clipped to ``grad_clip``, moments and
parameters stored in the parameters' dtype and updated in float32,
``lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p)``, the learning rate of
an update the schedule's value before the update's count.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import dense
from .dense import exact_float32, matmul, rms_norm

# elements a leaf's gradient sample holds at most: every k-th element of
# the flattened leaf, k = numel // SAMPLE (the harness samples the
# program's alike)
SAMPLE = 1 << 20


def _initial(s: dict, seed: int, device):
    """The harness's initial weights, drawn again from the seed one leaf
    at a time: (dotted path, leaf in its stored dtype)."""
    import models

    for path, leaf in models.draw_leaves(s, seed, device):
        yield ".".join(path), leaf


def route(s: dict, h: torch.Tensor, router: torch.Tensor, seq: int):
    """h [T, E] (T = rows x seq, row-major) -> (experts [T, k], gates
    [T, k], keep [T, k] bool, aux loss)."""
    n, k = s["n_experts"], s["top_k"]
    probs = torch.softmax(h @ router, dim=-1)                   # [T, n]
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, n).float().mean(0)
    aux = n * torch.sum(frac * probs.mean(0))
    values, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = values[:, :k] / values[:, :k].sum(-1, keepdim=True).clamp_min(
        1e-9)
    experts = experts[:, :k]
    capacity = max(1, int(s["capacity_factor"] * seq * k / n))
    keep = torch.zeros(experts.shape, dtype=torch.bool, device=h.device)
    rows = h.shape[0] // seq
    for r in range(rows):
        used = [0] * n
        block = experts[r * seq:(r + 1) * seq].tolist()
        flags = np.zeros((seq, k), bool)
        for choice in range(k):
            for t in range(seq):
                e = block[t][choice]
                if used[e] < capacity:
                    flags[t, choice] = True
                used[e] += 1
        keep[r * seq:(r + 1) * seq] = torch.from_numpy(flags).to(h.device)
    return experts, gates, keep, aux


def moe_block(s: dict, x, lw, seq: int, quant=None):
    """The expert half of a layer on the residual x [T, E]: (output,
    aux loss)."""
    h = rms_norm(x, lw["mlp_norm_scale"], s["norm_eps"])
    experts, gates, keep, aux = route(s, h, lw["router"], seq)
    out = torch.zeros_like(h)
    for e in range(s["n_experts"]):
        sel = (experts == e) & keep                               # [T, k]
        tokens = sel.any(dim=-1).nonzero()[:, 0]
        if tokens.numel() == 0:
            continue
        weight = (gates * sel.float()).sum(-1)[tokens]
        hi = h[tokens]
        act = F.silu(matmul(hi, lw["experts_gate"][e], quant)) * \
            matmul(hi, lw["experts_up"][e], quant)
        y = matmul(act, lw["experts_down"][e], quant)
        out = out.index_add(0, tokens, y * weight[:, None])
    return out, aux


def causal_rows(q, k, v, quant=None):
    """One sequence's causal attention, q [S, H, D], k/v [S, Hkv, D], in
    blocks of query rows, each block kept for autograd."""
    t, _, d = q.shape
    group = q.shape[1] // k.shape[1]
    kh = k.repeat_interleave(group, dim=1).transpose(0, 1)
    vh = v.repeat_interleave(group, dim=1).transpose(0, 1)
    blocks = []
    for lo in range(0, t, dense.Q_ROWS):
        hi = min(t, lo + dense.Q_ROWS)
        scores = dense._bmm(q[lo:hi].transpose(0, 1),
                            kh[:, :hi].transpose(1, 2), quant) * d ** -0.5
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        probs = torch.softmax(scores.masked_fill(mask, float("-inf")), -1)
        blocks.append(dense._bmm(probs, vh[:, :hi], quant).transpose(0, 1))
    return torch.cat(blocks)


def attention_block(s: dict, x, lw, cos, sin, seq: int, quant=None):
    """The attention half of a layer on x [rows * seq, E], each row its
    own causal sequence."""
    t, d = x.shape[0], s["head_dim"]
    h = rms_norm(x, lw["attn_norm_scale"], s["norm_eps"])
    q = matmul(h, lw["wq"], quant).view(t, -1, d)
    k = matmul(h, lw["wk"], quant).view(t, -1, d)
    v = matmul(h, lw["wv"], quant).view(t, -1, d)
    q, k = dense.rotate(q, cos, sin), dense.rotate(k, cos, sin)
    out = torch.cat([causal_rows(q[lo:lo + seq], k[lo:lo + seq],
                                 v[lo:lo + seq], quant)
                     for lo in range(0, t, seq)])
    return matmul(out.reshape(t, -1), lw["wo"], quant)


def _layer(s, seq, quant, x, cos, sin, *weights):
    lw = dict(zip(_LAYER_KEYS, weights))
    x = x + attention_block(s, x, lw, cos, sin, seq, quant)
    out, aux = moe_block(s, x, lw, seq, quant)
    return x + out, aux


_LAYER_KEYS = ("attn_norm_scale", "wq", "wk", "wv", "wo", "mlp_norm_scale",
               "router", "experts_gate", "experts_up", "experts_down")


def loss(s: dict, p: dict, tokens: torch.Tensor, targets: torch.Tensor,
         quant=None):
    """Mean cross-entropy over every target plus the aux weight times the
    layers' mean aux loss. tokens/targets [rows, seq]."""
    rows, seq = tokens.shape
    flat = tokens.reshape(-1)
    x = p["embedding"][flat]
    cos, sin = dense.rope(torch.arange(seq, device=flat.device).repeat(rows),
                          s["head_dim"], s["rope_theta"])
    auxes = []
    for layer in range(s["n_layers"]):
        weights = [p[f"layers.{key}"][layer] for key in _LAYER_KEYS]
        x, aux = checkpoint(_layer, s, seq, quant, x, cos, sin, *weights,
                            use_reentrant=False)
        auxes.append(aux)
    x = rms_norm(x, p["final_norm_scale"], s["norm_eps"])
    head = p["lm_head"] if "lm_head" in p else p["embedding"].T
    nll = []
    for lo in range(0, x.shape[0], 2048):
        logits = matmul(x[lo:lo + 2048], head, quant)
        nll.append(F.cross_entropy(logits, targets.reshape(-1)[lo:lo + 2048],
                                   reduction="sum"))
    ce = torch.stack(nll).sum() / flat.numel()
    return ce + s["router_aux_weight"] * torch.stack(auxes).mean()


def _schedule(opt: dict, count: int) -> float:
    """Linear warm-up from 0 to the peak, then cosine decay to 0."""
    peak, warm = opt["learning_rate"], opt["warmup_steps"]
    total = max(opt["total_steps"], warm + 1)
    if count < warm:
        return peak * count / warm
    steps = total - warm
    t = min(count - warm, steps)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / steps))


def train_reference(s: dict, seed: int, device, rows: list, opt: dict,
                    quant=None) -> dict:
    """Follow the program's checked steps from the same initial weights
    and rows: each step's loss, the first step's clipped gradient by leaf
    (its norm and a strided sample), and each leaf's change after the
    last step. Parameters are
    float32 leaves holding their stored dtype's values; the moments are
    stored in that dtype."""
    with exact_float32():
        stored, p, mu, nu = {}, {}, {}, {}
        for key, leaf in _initial(s, seed, device):
            stored[key] = leaf.dtype
            p[key] = leaf.float()
            mu[key] = torch.zeros_like(leaf)
            nu[key] = torch.zeros_like(leaf)
            del leaf
        keys = sorted(p)
        losses, first, first_samples = [], None, None
        for count, (tokens, targets) in enumerate(rows):
            for key in keys:
                p[key].requires_grad_(True)
            value = loss(s, p, torch.as_tensor(tokens, device=device),
                         torch.as_tensor(targets, device=device), quant)
            grads = list(torch.autograd.grad(value, [p[k] for k in keys]))
            losses.append(float(value.detach()))
            with torch.no_grad():
                norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
                clip = opt["grad_clip"]
                factor = clip / norm if clip and norm >= clip else 1.0
                lr = _schedule(opt, count)
                n = count + 1
                bc1, bc2 = 1 - opt["b1"] ** n, 1 - opt["b2"] ** n
                norms, samples = {}, {}
                for i, key in enumerate(keys):
                    g = grads[i].mul_(factor)
                    grads[i] = None
                    norms[key] = float(g.norm())
                    flat = g.reshape(-1)
                    samples[key] = flat[::max(1, flat.numel() // SAMPLE)] \
                        .cpu()
                    m = g * (1 - opt["b1"]) + mu[key].float() * opt["b1"]
                    mu[key] = m.to(stored[key])
                    v = g * g * (1 - opt["b2"]) + nu[key].float() * opt["b2"]
                    nu[key] = v.to(stored[key])
                    del g, m, v
                    update = (mu[key].float() / bc1) / (
                        torch.sqrt(nu[key].float() / bc2) + 1e-8)
                    if opt["weight_decay"]:
                        update = update + opt["weight_decay"] * p[key]
                    p[key] = _round(p[key].detach() - lr * update,
                                    stored[key])
                    del update
                if first is None:
                    first, first_samples = norms, samples
        change = {key: float((p[key] - leaf.float()).norm())
                  for key, leaf in _initial(s, seed, device)}
    return {"losses": losses, "grad_norms": first,
            "grad_samples": first_samples, "change_norms": change}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to the stored dtype, held in float32."""
    return x.to(dtype).float()
