"""Every input of a run, made from `--seed` on the run's device.

The parameters are drawn in the port's layout (`{"embed", "final_norm",
"head", "blocks": [...]}`, each `W` [d_in, d_out], f32) as plain seeded
draws: one flat f32 buffer filled by a few large `torch.randn` calls,
one generator a chunk of `CHUNK` elements, each leaf a view of it scaled
by its standard deviation; the norm scales are ones.  A chunk can be
drawn again alone, so the change of every leaf from its first value can
be read without keeping a copy (`change_norms`).

The same seed gives the same tensors; the program and the reference get
the same ones, and the reference draws its own copy again.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from perfbench.cells import Sizes

CHUNK = 1 << 27
# streams of one seed: the token pools, then the parameter chunks
TOKENS, REQUESTS, PARAMS = 1, 2, 1000


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) % (1 << 46)) * (1 << 16) + stream)
    return g


def host_rng(seed: int, stream: int) -> random.Random:
    return random.Random((int(seed) % (1 << 46)) * (1 << 16) + stream)


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str          # "embed", "blocks.3.wq", ...
    shape: Tuple[int, ...]
    std: Optional[float]   # None: a norm scale, ones
    offset: int = 0    # into the flat buffer of random leaves

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def layout(s: Sizes) -> List[Leaf]:
    """The leaves in the port's order (`model.init_params`)."""
    d, f = s.d_model, s.d_ff
    out: List[Tuple[str, Tuple[int, ...], Optional[float]]] = [
        ("embed", (s.vocab, d), d ** -0.5), ("final_norm", (d,), None),
        ("head", (d, s.vocab), d ** -0.5)]
    for i in range(s.n_layers):
        p = f"blocks.{i}."
        out += [(p + "attn_norm", (d,), None)]
        out += [(p + w, (d, d), d ** -0.5) for w in ("wq", "wk", "wv", "wo")]
        out += [(p + "mlp_norm", (d,), None),
                (p + "w_gate", (d, f), d ** -0.5),
                (p + "w_up", (d, f), d ** -0.5),
                (p + "w_down", (f, d), f ** -0.5)]
    leaves, offset = [], 0
    for name, shape, std in out:
        leaves.append(Leaf(name, shape, std, offset))
        if std is not None:
            offset += math.prod(shape)
    return leaves


def n_random(leaves: List[Leaf]) -> int:
    return sum(x.numel for x in leaves if x.std is not None)


def _draw_chunk(seed: int, c: int, n: int, out: torch.Tensor) -> None:
    torch.randn(n, generator=generator(seed, PARAMS + c, out.device),
                out=out)


def nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{"blocks.3.wq": x, ...} -> the port's nested dict."""
    tree: Dict[str, Any] = {"blocks": []}
    for name, x in flat.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            i = int(parts[1])
            while len(tree["blocks"]) <= i:
                tree["blocks"].append({})
            tree["blocks"][i][parts[2]] = x
        else:
            tree[name] = x
    order = ["embed", "final_norm", "head", "blocks"]
    return {k: tree[k] for k in order if k in tree}


def named(tree: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a nested param dict, in the port's order."""
    for name, x in tree.items():
        if name != "blocks":
            yield name, x
    for i, blk in enumerate(tree.get("blocks", ())):
        for name, x in blk.items():
            yield f"blocks.{i}.{name}", x


def make_params(s: Sizes, seed: int, device) -> Dict[str, Any]:
    """f32 params in the port's layout: views of one flat buffer."""
    leaves = layout(s)
    total = n_random(leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for c in range(0, (total + CHUNK - 1) // CHUNK):
        lo = c * CHUNK
        _draw_chunk(seed, c, min(CHUNK, total - lo), flat[lo:lo + CHUNK])
    out = {}
    for x in leaves:
        if x.std is None:
            out[x.name] = torch.ones(x.shape, device=device)
        else:
            out[x.name] = flat[x.offset:x.offset + x.numel].view(x.shape)
            out[x.name].mul_(x.std)
    return nest(out)


@torch.no_grad()
def change_norms(params: Dict[str, Any], s: Sizes, seed: int
                 ) -> Dict[str, float]:
    """Each leaf's ||p - p0||, p0 its value from `make_params`, drawn
    again a chunk at a time."""
    leaves = layout(s)
    by_name = dict(named(params))
    sq = {x.name: 0.0 for x in leaves}
    for x in leaves:
        if x.std is None:
            sq[x.name] = float((by_name[x.name].float() - 1.0).square().sum())
    total = n_random(leaves)
    dev = next(iter(by_name.values())).device
    buf = torch.empty(min(CHUNK, total), dtype=torch.float32, device=dev)
    rand = [x for x in leaves if x.std is not None]
    for c in range(0, (total + CHUNK - 1) // CHUNK):
        lo, n = c * CHUNK, min(CHUNK, total - c * CHUNK)
        _draw_chunk(seed, c, n, buf[:n])
        for x in rand:
            a, b = max(lo, x.offset), min(lo + n, x.offset + x.numel)
            if a >= b:
                continue
            p = by_name[x.name].reshape(-1)[a - x.offset:b - x.offset]
            sq[x.name] += float((p.float() - buf[a - lo:b - lo] * x.std)
                                .square().sum())
    return {k: math.sqrt(v) for k, v in sq.items()}


def token_pool(seed: int, stream: int, shape: Tuple[int, ...], vocab: int,
               device) -> torch.Tensor:
    """Uniform int64 token ids of `shape`, drawn on the device."""
    return torch.randint(0, vocab, shape, dtype=torch.int64, device=device,
                         generator=generator(seed, stream, device))
