"""Random weights for a configuration file, drawn from the seed on the
device the run uses, in the port's parameter layout.

One flat f32 buffer holds every leaf; it is filled with standard normals
by a ``torch.Generator`` on the device in a few large calls, and each leaf
(a view into it) is then scaled as the port's own initialisers scale it:
``1/sqrt(fan_in)`` for projections and experts, 0.02 for the embedding,
ones for the norms.  The port and the reference are handed the same
tensors, so one copy of the weights fits on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["layout", "make"]

_CHUNK = 1 << 30  # elements a normal_ call fills

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]  # path, shape, scale


def _vocab_padded(v: int) -> int:
    return -(-v // 256) * 256


def layout(c: dict) -> List[Leaf]:
    """Every leaf of configuration file ``c`` in the port's tree: (path,
    shape, scale), scale 0 meaning a norm's ones."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    kh = c.get("num_key_value_heads") or h
    vp = _vocab_padded(c["vocab_size"])
    leaves: List[Leaf] = [(("embed",), (vp, d), 0.02)]

    def dense(path, n, fan_in, out):
        leaves.append((path, (n, fan_in) + tuple(out), fan_in ** -0.5))

    def block(seg: str, n: int, moe: bool):
        leaves.append(((seg, "ln1"), (n, d), 0.0))
        a = (seg, "attn")
        if c.get("kv_lora_rank"):
            nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
            lora, dv = c["kv_lora_rank"], c["v_head_dim"]
            dense(a + ("wq",), n, d, (h * (nope + rope),))
            dense(a + ("wkv_a",), n, d, (lora + rope,))
            leaves.append((a + ("kv_norm",), (n, lora), 0.0))
            dense(a + ("wkv_b",), n, lora, (h * (nope + dv),))
            dense(a + ("wo",), n, h * dv, (d,))
        else:
            dh = c.get("head_dim") or d // h
            dense(a + ("wq",), n, d, (h * dh,))
            dense(a + ("wk",), n, d, (kh * dh,))
            dense(a + ("wv",), n, d, (kh * dh,))
            dense(a + ("wo",), n, h * dh, (d,))
        leaves.append(((seg, "ln2"), (n, d), 0.0))
        if moe:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            m = (seg, "moe")
            dense(m + ("router",), n, d, (e,))
            leaves.append((m + ("wg",), (n, e, d, f), d ** -0.5))
            leaves.append((m + ("wu",), (n, e, d, f), d ** -0.5))
            leaves.append((m + ("wd",), (n, e, f, d), f ** -0.5))
            fs = c["n_shared_experts"] * f
            dense(m + ("shared", "gate"), n, d, (fs,))
            dense(m + ("shared", "up"), n, d, (fs,))
            dense(m + ("shared", "down"), n, fs, (d,))
        else:
            ff = c["intermediate_size"]
            dense((seg, "mlp", "gate"), n, d, (ff,))
            dense((seg, "mlp", "up"), n, d, (ff,))
            dense((seg, "mlp", "down"), n, ff, (d,))

    n_dense = c["first_k_dense_replace"]
    segs = [("dense", n_dense)] if n_dense else []
    segs.append(("moe", c["num_hidden_layers"] - n_dense))
    for i, (kind, n) in enumerate(segs):
        block(f"seg{i}", n, kind == "moe")
    leaves.append((("final_norm",), (d,), 0.0))
    if not c["tie_word_embeddings"]:
        leaves.append((("head",), (d, vp), d ** -0.5))
    return leaves


def make(c: dict, seed: int, device) -> Dict:
    """The weight tree of configuration file ``c`` for ``seed`` on
    ``device`` (f32)."""
    leaves = layout(c)
    sizes = [torch.Size(shape).numel() for _, shape, _ in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    for lo in range(0, flat.numel(), _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)
    tree: Dict = {}
    at = 0
    for (path, shape, scale), n in zip(leaves, sizes):
        leaf = flat[at:at + n].view(shape)
        at += n
        if scale:
            leaf.mul_(scale)
        else:
            leaf.fill_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
