"""Plain reference of a dense decoder-only transformer of the Qwen3 kind:
token embedding, per layer RMSNorm -> grouped-query attention (q / k
RMSNorm over the head, rotary embedding by rotating halves, causal
softmax) -> residual, RMSNorm -> SwiGLU MLP -> residual, final RMSNorm,
logits by the embedding's transpose when tied, mean cross-entropy.

It reads the published ``config.json`` keys of the configuration file and
imports nothing of the program under test.  Parameters come in the layout
the program takes (one dict per layer under ``blocks``), so both sides get
the same tensors; every computation here is float32 (or the control's
precision, `numerics.matmul`), one layer at a time, each layer
recomputed in the backward to bound the activations held.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    return dict(d=d, h=h, hkv=conf["num_key_value_heads"],
                hd=conf.get("head_dim") or d // h,
                f=conf["intermediate_size"], v=conf["vocab_size"],
                layers=conf["num_hidden_layers"])


def make_params(conf: dict, seed: int, device) -> dict:
    """Weights from ``seed``, drawn on ``device`` by a generator there:
    every matrix N(0, initializer_range) in one draw per kind of matrix
    over all layers, norm scales one; in the configuration's dtype."""
    k = _dims(conf)
    dt = DTYPES[conf["torch_dtype"]]
    std = conf["initializer_range"]
    gen = torch.Generator(device=device).manual_seed(seed)
    n = k["layers"]

    def draw(shape):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(0.0, std, generator=gen).to(dt)

    d, h, hkv, hd, f = k["d"], k["h"], k["hkv"], k["hd"], k["f"]
    table = draw((k["v"], d))
    wq, wk, wv = (draw((n, d, hh, hd)) for hh in (h, hkv, hkv))
    wo = draw((n, h, hd, d))
    w_gate, w_up = draw((n, d, f)), draw((n, d, f))
    w_down = draw((n, f, d))

    def ones(m):
        return torch.ones(m, dtype=dt, device=device)

    blocks = [{"pos0": {
        "norm1": {"scale": ones(d)},
        "mixer": {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i],
                  "q_norm": {"scale": ones(hd)},
                  "k_norm": {"scale": ones(hd)}},
        "norm2": {"scale": ones(d)},
        "ffn": {"w_down": w_down[i], "w_gate": w_gate[i],
                "w_up": w_up[i]}}} for i in range(n)]
    embed = {"table": table}
    if not conf["tie_word_embeddings"]:
        embed["lm_head"] = draw((d, k["v"]))
    return {"embed": embed, "blocks": blocks,
            "final_norm": {"scale": ones(d)}}


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): positions 0..S-1, frequency pair j at
    theta^(-2j/hd), the first half of the head rotated against the
    second."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) * 2.0 / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x, p, conf, mm):
    k = _dims(conf)
    eps, b, s = conf["rms_norm_eps"], x.shape[0], x.shape[1]
    h, hkv, hd, d = k["h"], k["hkv"], k["hd"], k["d"]
    a = p["mixer"]
    y = _rms(x, p["norm1"]["scale"], eps)
    q = mm(y, a["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    kk = mm(y, a["wk"].reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
    v = mm(y, a["wv"].reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
    q = _rope(_rms(q, a["q_norm"]["scale"], eps), conf["rope_theta"])
    kk = _rope(_rms(kk, a["k_norm"]["scale"], eps), conf["rope_theta"])
    rep = h // hkv
    kk = kk.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (z.transpose(1, 2) for z in (q, kk, v))   # (B, H, S, hd)
    scores = mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), vh).transpose(1, 2)
    x = x + mm(o.reshape(b, s, h * hd), a["wo"].reshape(h * hd, d))
    f = p["ffn"]
    y = _rms(x, p["norm2"]["scale"], eps)
    gate = F.silu(mm(y, f["w_gate"]))
    return x + mm(gate * mm(y, f["w_up"]), f["w_down"])


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         conf: dict, mm) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S) ``tokens`` against
    ``labels``; ``params`` hold float32 leaves."""
    x = params["embed"]["table"][tokens.long()]
    for blk in params["blocks"]:
        x = checkpoint.checkpoint(_layer, x, blk["pos0"], conf, mm,
                                  use_reentrant=False)
    x = _rms(x, params["final_norm"]["scale"], conf["rms_norm_eps"])
    head = (params["embed"]["table"].t() if conf["tie_word_embeddings"]
            else params["embed"]["lm_head"])
    logits = mm(x, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def quadratic_width(conf: dict) -> int:
    """Summed width of the layers whose work grows with the square of the
    sequence: every layer's attention, H x hd."""
    k = _dims(conf)
    return k["layers"] * k["h"] * k["hd"]
