"""ToMe: bipartite soft token matching and merging, PyTorch edition.

Port of ``qa_tiger_tpu/ops/tome.py`` (the reference's ``src/tome/merge.py``):
split the tokens into alternating sets A and B, score every A token against
every B token by cosine similarity, merge the r best-matched A tokens into
their B match and keep the rest, in the order ``cat([unm, dst])``.

Each layer's r is fixed (``tome_schedule``), so every shape is known before
the forward. Ties sort as in JAX: the edge order is a stable descending
sort, the best match the first maximum. Merging sums with ``scatter_add``;
on a CUDA tensor colliding sources add in no fixed order (PERF.md gives the
size of that difference).
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch


def parse_r(num_layers: int, r) -> list[int]:
    """Expand a constant, an ``(r, inflection)`` schedule or an explicit
    list into one r per layer (reference src/tome/utils.py:80-105)."""
    inflect = 0.0
    if isinstance(r, list):
        if len(r) < num_layers:
            r = r + [0] * (num_layers - len(r))
        return list(r)
    if isinstance(r, tuple):
        r, inflect = r
    min_val = int(r * (1.0 - inflect))
    max_val = 2 * r - min_val
    step = (max_val - min_val) / (num_layers - 1)
    return [int(min_val + step * i) for i in range(num_layers)]


def effective_r(t: int, r: int, protected: int = 0) -> int:
    """r capped at half the unprotected tokens (src/tome/merge.py:43-44)."""
    return max(0, min(r, (t - protected) // 2))


def tome_schedule(t0: int, rs: Sequence[int], protected: int = 1) -> list[tuple[int, int]]:
    """[(r_eff, tokens_after)] per layer: t0=577, rs=[25]*23 ends at 14."""
    plan = []
    t = t0
    for r in rs:
        r_eff = effective_r(t, r, protected)
        t -= r_eff
        plan.append((r_eff, t))
    return plan


def _index(idx: torch.Tensor, channels: int) -> torch.Tensor:
    return idx[..., None].expand(*idx.shape, channels)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], idx [B, K] -> x[b, idx[b]] as [B, K, C]."""
    return torch.gather(x, 1, _index(idx, x.shape[-1]))


def _scatter_mode(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """dst[b, idx[b, i]] (+)= src[b, i] by ``mode``: sum, amax, or mean
    (torch ``scatter_reduce(reduce='mean', include_self=True)``)."""
    index = _index(idx, dst.shape[-1])
    if mode == "sum":
        return dst.scatter_add(1, index, src)
    if mode == "amax":
        return dst.scatter_reduce(1, index, src, "amax", include_self=True)
    if mode == "mean":
        ones = torch.ones(dst.shape[:-1] + (1,), dtype=dst.dtype, device=dst.device)
        counts = ones.scatter_add(1, idx[..., None], torch.ones_like(src[..., :1]))
        return dst.scatter_add(1, index, src) / counts
    raise ValueError(f"unknown merge mode {mode!r}")


def _identity(x, mode="mean"):
    return x


def bipartite_soft_matching(metric: torch.Tensor, r: int, class_token: bool = False,
                            distill_token: bool = False) -> tuple[Callable, Callable]:
    """(merge, unmerge) for [B, T, C] token tensors (src/tome/merge.py:18-97).

    A = even tokens, B = odd tokens; the class token (A[0]) and the distill
    token (B[0]) are protected by -inf scores. ``merge.indices`` holds the
    layer's matching: ``unm``, ``src`` and ``dst`` index tensors and
    ``score``, each A token's best similarity."""
    protected = int(class_token) + int(distill_token)
    t = metric.shape[1]
    r = effective_r(t, r, protected)
    if r <= 0:
        return _identity, _identity

    metric = metric / torch.linalg.norm(metric, dim=-1, keepdim=True)
    a, b = metric[..., ::2, :], metric[..., 1::2, :]
    scores = a.float() @ b.float().transpose(-1, -2)
    if class_token:
        scores[..., 0, :] = float("-inf")
    if distill_token:
        scores[..., :, 0] = float("-inf")

    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)                       # [B, Ta]
    edge_idx = torch.argsort(node_max, dim=-1, descending=True, stable=True)
    unm_idx = edge_idx[..., r:]                            # [B, Ta - r]
    src_idx = edge_idx[..., :r]                            # [B, r]
    dst_idx = torch.gather(node_idx, -1, src_idx)          # [B, r]
    if class_token:
        unm_idx = torch.sort(unm_idx, dim=-1).values  # keep the class token first

    def merge(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        src, dst = x[..., ::2, :], x[..., 1::2, :]
        unm = _take(src, unm_idx)
        dst = _scatter_mode(dst, dst_idx, _take(src, src_idx), mode)
        if distill_token:
            return torch.cat([unm[:, :1], dst[:, :1], unm[:, 1:], dst[:, 1:]], dim=1)
        return torch.cat([unm, dst], dim=1)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        unm_len = unm_idx.shape[1]
        unm, dst = x[..., :unm_len, :], x[..., unm_len:, :]
        c = x.shape[-1]
        out = torch.zeros(x.shape[:-2] + (t, c), dtype=x.dtype, device=x.device)
        out[..., 1::2, :] = dst
        out = out.scatter(1, _index(2 * unm_idx, c), unm)
        return out.scatter(1, _index(2 * src_idx, c), _take(dst, dst_idx))

    merge.indices = {"unm": unm_idx, "src": src_idx, "dst": dst_idx, "score": node_max}
    return merge, unmerge


def kth_bipartite_soft_matching(metric: torch.Tensor, k: int) -> tuple[Callable, Callable]:
    """ToMe with sets (every k-th token, the rest): n tokens -> n // k
    (src/tome/merge.py:100-153)."""
    if k <= 1:
        return _identity, _identity
    t_rnd = (metric.shape[1] // k) * k

    def split(x):
        n = x.shape[0]
        x = x[:, :t_rnd].reshape(n, -1, k, x.shape[-1])
        return x[:, :, : k - 1].reshape(n, -1, x.shape[-1]), x[:, :, k - 1]

    metric = metric / torch.linalg.norm(metric, dim=-1, keepdim=True)
    a, b = split(metric)
    dst_idx = (a.float() @ b.float().transpose(-1, -2)).argmax(dim=-1)

    def merge(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        src, dst = split(x)
        return _scatter_mode(dst, dst_idx, src, mode)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        n, _, c = x.shape
        src = _take(x, dst_idx).reshape(n, -1, k - 1, c)
        dst = x.reshape(n, -1, 1, c)
        return torch.cat([src, dst], dim=-2).reshape(n, -1, c)

    return merge, unmerge


def random_bipartite_soft_matching(metric: torch.Tensor, r: int,
                                   generator: torch.Generator | None = None
                                   ) -> tuple[Callable, Callable]:
    """ToMe with a random r-token source set (src/tome/merge.py:156-207).
    The permutations come from ``generator`` (seed 0 when None); they are
    not JAX's."""
    if r <= 0:
        return _identity, _identity
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    B, N, _ = metric.shape
    rand_idx = torch.rand(B, N, generator=generator, device=generator.device).argsort(dim=1)
    rand_idx = rand_idx.to(metric.device)
    a_idx, b_idx = rand_idx[:, :r], rand_idx[:, r:]

    def split(x):
        return _take(x, a_idx), _take(x, b_idx)

    metric = metric / torch.linalg.norm(metric, dim=-1, keepdim=True)
    a, b = split(metric)
    dst_idx = (a.float() @ b.float().transpose(-1, -2)).argmax(dim=-1)

    def merge(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        src, dst = split(x)
        return _scatter_mode(dst, dst_idx, src, mode)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        out = torch.zeros(B, N, c, dtype=x.dtype, device=x.device)
        out = out.scatter(1, _index(a_idx, c), _take(x, dst_idx))
        return out.scatter(1, _index(b_idx, c), x)

    return merge, unmerge


def merge_wavg(merge: Callable, x: torch.Tensor, size: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Size-weighted average merge (src/tome/merge.py:210-225)."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    x = merge(x * size, mode="sum")
    size = merge(size, mode="sum")
    return x / size, size


def merge_source(merge: Callable, x: torch.Tensor, source: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Token-provenance adjacency (src/tome/merge.py:228-241)."""
    if source is None:
        n, t, _ = x.shape
        source = torch.eye(t, dtype=x.dtype, device=x.device).expand(n, t, t)
    return merge(source, mode="amax")
