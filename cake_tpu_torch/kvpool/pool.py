"""The KV page pool on the device and the gathers and scatters over it (port
of ``cake_tpu/kvpool/pool.py``).

Physical layout: one pooled buffer per cache half,

    ``[num_layers, num_pages, kv_heads, page_size, head_dim]``

(the int8 cache adds the per-slot scale half without the trailing
``head_dim``, as :class:`~cake_tpu_torch.ops.kvcache.QuantizedKV` does).
Over a rank mesh (dp 1) each rank's pool holds its own layers and KV
heads, ``[L/S, P, KH/tp, page_size, D]``; the page tables are the same
on every rank.

A decode dispatch addresses the pool through two small int32 operands:

- ``page_map [B, pages_per_stream]``: each stream's logical -> physical
  page list, sink-padded past its frontier. :func:`gather_view` copies
  these pages into the standard contiguous ``[L, B, KH, S, D]`` view and
  the unchanged decode body (the attention kernels, the per-row KV
  writes) runs over it, so paged streams equal slot streams bit for bit:
  the view holds the slot cache's contents;
- ``scatter_ids [B, W]``: the physical pages receiving this dispatch's KV
  writes (the ``W`` pages covering ``[pos, pos + steps)`` of each row;
  the sink for retired rows and overruns). Only these pages go back
  (:func:`scatter_back`).

:func:`row_gather`, :func:`row_scatter` and :func:`batch_scatter` move
whole staged rows between the admission plane's contiguous batch-1
staging caches and pool pages. Every function is plain PyTorch indexing
on the tensors' own device (the JAX package leaves the same work to XLA);
nothing but these functions and the decode write-back writes to the pool.
The sink is skipped where a host-side id list says which pages are real:
its content is garbage by design.
"""

from __future__ import annotations

import numpy as np
import torch

from cake_tpu_torch.kvpool.table import SINK
from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.kvcache import KVCache, QuantizedKV


def halves(cache: KVCache) -> list[torch.Tensor]:
    """Every tensor of a cache or pool (k and v, codes and scales), in a
    fixed order."""
    out = []
    for half in (cache.k, cache.v):
        out += [half.q, half.scale] if isinstance(half, QuantizedKV) \
            else [half]
    return out


def _rebuild(like: KVCache, bufs: list[torch.Tensor]) -> KVCache:
    """A cache of ``like``'s structure over ``bufs`` (:func:`halves`
    order)."""
    if isinstance(like.k, QuantizedKV):
        return KVCache(k=QuantizedKV(bufs[0], bufs[1]),
                       v=QuantizedKV(bufs[2], bufs[3]))
    return KVCache(k=bufs[0], v=bufs[1])


def page_size_of(pool: KVCache) -> int:
    return halves(pool)[0].shape[3]


def writeback_width(steps: int, page_size: int, pages_per_stream: int) -> int:
    """Pages a ``steps``-token dispatch can touch a row: the span of
    ``steps`` consecutive positions crosses at most this many page
    boundaries whatever its alignment."""
    return min(pages_per_stream, 1 + (steps + page_size - 2) // page_size)


def init_pool(config: LlamaConfig, num_pages: int, page_size: int,
              quant: str | None = None, device=None) -> KVCache:
    """A zeroed page pool in the model's dtype, or int8 with per-slot
    scales (``quant="int8"``)."""
    if quant not in (None, "int8"):
        raise ValueError(f"unsupported kv quant={quant!r}")
    shape = (config.num_hidden_layers, num_pages,
             config.num_key_value_heads, page_size, config.head_dim)
    if quant == "int8":
        def half():
            return QuantizedKV(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device))

        return KVCache(k=half(), v=half())
    dt = config.torch_dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def _gather_buf(buf: torch.Tensor, page_map: torch.Tensor) -> torch.Tensor:
    """``[L, P, KH, ps(, D)]`` pool half + ``[B, Ppp]`` page map ->
    contiguous ``[L, B, KH, Ppp * ps(, D)]``."""
    L, _, KH, ps = buf.shape[:4]
    tail = tuple(buf.shape[4:])
    B, ppp = page_map.shape
    g = buf.index_select(1, page_map.reshape(-1).long())
    g = g.view((L, B, ppp, KH, ps) + tail).transpose(2, 3)
    return g.reshape((L, B, KH, ppp * ps) + tail)


def gather_view(pool: KVCache, page_map: torch.Tensor) -> KVCache:
    """The standard contiguous cache view of every stream's pages: the
    unchanged decode body runs over it (a copy: its writes stay in the
    view until :func:`scatter_back`)."""
    return _rebuild(pool, [_gather_buf(b, page_map) for b in halves(pool)])


def scatter_back(pool: KVCache, view: KVCache, first_page: torch.Tensor,
                 scatter_ids: torch.Tensor) -> None:
    """Write each row's pages ``first_page[b] .. first_page[b] + W - 1``
    of the contiguous ``view`` into the pool at ``scatter_ids [B, W]``, in
    place. Sink ids absorb retired rows and overruns; the sink is never
    attendable, so its duplicate writes are harmless."""
    B, w = scatter_ids.shape
    ids = scatter_ids.reshape(-1).long()
    rows = torch.arange(B, device=ids.device)[:, None].expand(B, w)
    pages = first_page.reshape(B, 1).long() + torch.arange(
        w, device=ids.device)
    for pbuf, vbuf in zip(halves(pool), halves(view)):
        L, _, KH, ps = pbuf.shape[:4]
        tail = tuple(pbuf.shape[4:])
        S = vbuf.shape[3]
        paged = vbuf.view((L, B, KH, S // ps, ps) + tail).transpose(2, 3)
        u = paged[:, rows, pages]                # [L, B, W, KH, ps(, D)]
        pbuf[:, ids] = u.reshape((L, B * w, KH, ps) + tail)


def row_gather(pool: KVCache, ids) -> KVCache:
    """Pool pages ``ids [Ppp]`` (sink-padded) -> a batch-1 staging cache
    ``[L, 1, KH, Ppp * ps(, D)]``: the start of a prefix-hit admission,
    and the read of an export."""
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    out = []
    for buf in halves(pool):
        g = buf.index_select(1, ids.to(buf.device))  # [L, Ppp, KH, ps(, D)]
        L, ppp, KH, ps = g.shape[:4]
        out.append(g.transpose(1, 2).reshape(
            (L, 1, KH, ppp * ps) + tuple(g.shape[4:])))
    return _rebuild(pool, out)


def _real(ids) -> tuple[np.ndarray, np.ndarray]:
    """Positions and values of the non-sink entries of a host id list."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    at = np.flatnonzero(ids != SINK)
    return at, ids[at]


def row_scatter(pool: KVCache, staging: KVCache, ids) -> None:
    """A staged batch-1 row's logical pages into the pool at ``ids
    [Ppp]``, in place; sink entries are skipped (the pages they name
    stay as they are): the paged admission "splice", a page write."""
    at, pids = _real(ids)
    if not len(at):
        return
    dev = halves(pool)[0].device
    at_t = torch.as_tensor(at, device=dev)
    pid_t = torch.as_tensor(pids, device=dev)
    for pbuf, sbuf in zip(halves(pool), halves(staging)):
        L, _, KH, ps = pbuf.shape[:4]
        tail = tuple(pbuf.shape[4:])
        S = sbuf.shape[3]
        paged = sbuf.view((L, KH, S // ps, ps) + tail).transpose(1, 2)
        pbuf[:, pid_t] = paged.index_select(1, at_t)


def batch_scatter(pool: KVCache, cache: KVCache, ids) -> None:
    """A whole prefilled ``[L, B, KH, S(, D)]`` batch cache into the pool,
    in place: page ``p`` of row ``b`` goes to ``ids[b * Ppp + p]``; sink
    entries are skipped. The set_prompts hand-off to the pool."""
    at, pids = _real(ids)
    if not len(at):
        return
    dev = halves(pool)[0].device
    at_t = torch.as_tensor(at, device=dev)
    pid_t = torch.as_tensor(pids, device=dev)
    for pbuf, cbuf in zip(halves(pool), halves(cache)):
        L, _, KH, ps = pbuf.shape[:4]
        tail = tuple(pbuf.shape[4:])
        B, S = cbuf.shape[1], cbuf.shape[3]
        ppp = S // ps
        paged = cbuf.view((L, B, KH, ppp, ps) + tail).transpose(2, 3)
        pbuf[:, pid_t] = paged[:, at_t // ppp, at_t % ppp]


def write_pages(pool: KVCache, pids, pages: list[list[torch.Tensor]]
                ) -> None:
    """Host page tensors into the pool at ``pids``, in place: ``pages[j]``
    holds page ``j``'s tensors in :func:`halves` order, each ``[L, KH,
    ps(, D)]`` (an import's pages, one upload)."""
    if not pages:
        return
    bufs = halves(pool)
    pid_t = torch.as_tensor(np.asarray(pids, np.int64),
                            device=bufs[0].device)
    for i, pbuf in enumerate(bufs):
        stack = torch.stack([p[i] for p in pages], dim=1)  # [L, n, KH, ...]
        pbuf[:, pid_t] = stack.to(pbuf.device, pbuf.dtype)
