"""The port's paged KV layout (``cake_tpu_torch/kvpool`` and
``BatchGenerator(kv_layout="paged")``) against the JAX package's.

- ``PagePool``/``PrefixTree``: the JAX package's unit cases
  (``tests/test_kvpool.py``), run against both packages' classes;
- the page moves: ``gather_view``, ``scatter_back``, ``row_gather``,
  ``row_scatter`` and ``batch_scatter`` on the same numpy pool, page map
  and ids give the JAX functions' arrays exactly (bf16 values held in f32,
  and int8 codes with f32 scales); the sink page is left out of the pool
  comparison: its content is garbage by design, and duplicate sink writes
  land in an unspecified order in both packages;
- the engine: one serving scenario through both packages' paged engines
  from the same f32 weights (``tiny(max_seq_len=64)``, page size 8): four
  prompts sharing a 20-id prefix (two shared pages and a copy-on-write
  boundary page each), one 6 slots from the window's edge, a stream
  retired with ``finish``, two arrivals (one a prefix-tree hit); every
  emitted row, the counters, the page tables and the pool's bookkeeping
  must be identical, at blocks 1 and 4, over the int8 pool with int8
  weights, and over int4 g32 weights. Then a constrained stream, and a
  minimum pool under pressure (prefix-tree evictions, and an arrival
  deferred behind pinned imports);
- the port's paged streams equal its slot streams, greedy and sampled;
- pool sizing and constructor validation with the JAX messages.

Exact equality throughout: ids, page tables, pool tensors.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cake_tpu.constrain import Guide as JGuide
from cake_tpu.constrain import build_token_dfa as jbuild_dfa
from cake_tpu.kvpool import PagePool as JPagePool
from cake_tpu.kvpool import PoolExhausted as JPoolExhausted
from cake_tpu.kvpool import PrefixTree as JPrefixTree
from cake_tpu.kvpool import pool as jpool
from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import quant as jq
from cake_tpu.ops.kvcache import KVCache as JKVCache
from cake_tpu.ops.kvcache import QuantizedKV as JQuantizedKV
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel.mesh import MeshPlan
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu_torch.constrain import Guide, build_token_dfa
from cake_tpu_torch.kvpool import PagePool, PoolExhausted, PrefixTree
from cake_tpu_torch.kvpool import pool as tpool
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.kvcache import KVCache, QuantizedKV
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator

PACKAGES = {"jax": (JPagePool, JPrefixTree, JPoolExhausted),
            "port": (PagePool, PrefixTree, PoolExhausted)}
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, top_k=20, seed=11)
PS = 8  # tokens a page
PREFIX = [(i * 7) % 100 + 2 for i in range(20)]  # 2 full pages + 4
PROMPTS = [PREFIX + [5, 9, 2], PREFIX + [3, 1, 4, 1], PREFIX + [8, 8],
           PREFIX + [(i * 5) % 90 + 3 for i in range(38)]]  # 58 of 64
ARRIVALS = [(PREFIX + [4, 4, 4], 10), ([9, 8, 7, 6, 5], 11)]
LONG = [(i * 11) % 97 + 2 for i in range(60)]
STEPS = (6, 26)
# (bits, group size) of each weight tier, and its KV cache
TIERS = {"f32": (None, None, None), "int8+kv8": (8, None, "int8"),
         "int4g32": (4, 32, None)}
SMALL = dict(admit_chunk=8, prefix_share_min=8, prefix_block=8)


class _Small(BatchGenerator):
    ADMIT_CHUNK = SMALL["admit_chunk"]
    PREFIX_SHARE_MIN = SMALL["prefix_share_min"]
    PREFIX_BLOCK = SMALL["prefix_block"]


# -- host-side units: both packages' classes ---------------------------------
@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_pool_alloc_free_refcounts(pkg):
    p = pkg[0](8, 4)
    a = p.alloc()
    assert p.refcount(a) == 1 and p.free_count == 6  # sink excluded
    p.ref(a)
    assert p.shared_count == 1
    assert not p.unref(a)
    assert p.shared_count == 0
    assert p.unref(a)
    assert p.free_count == 7


def test_pool_sink_is_pinned_and_exhaustion_raises(pkg):
    p = pkg[0](4, 4)
    got = {p.alloc() for _ in range(3)}
    assert 0 not in got
    with pytest.raises(pkg[2]):
        p.alloc()


def test_pool_pow2_size_and_unref_validation(pkg):
    with pytest.raises(ValueError):
        pkg[0](12, 4)
    with pytest.raises(ValueError):
        pkg[0](8, 0)
    with pytest.raises(ValueError):
        pkg[0](8, 4).unref(3)


def test_pool_pins_survive_unrefs(pkg):
    p = pkg[0](8, 4)
    a = p.alloc()
    p.pin(a)
    assert not p.unref(a) and p.pinned_count == 1
    assert p.unpin(a) and p.free_count == 7 and p.pinned_count == 0


def _tree(pkg, pages=16, ps=4):
    pool = pkg[0](pages, ps)
    return pool, pkg[1](pool)


def test_tree_insert_match_page_aligned(pkg):
    pool, t = _tree(pkg)
    ids = list(range(1, 11))
    pages = [pool.alloc(), pool.alloc()]
    t.insert(ids, pages)
    assert pool.refcount(pages[0]) == 2
    assert t.match(ids) == (8, pages)


def test_tree_match_strictly_shorter_than_prompt(pkg):
    pool, t = _tree(pkg)
    ids = [1, 2, 3, 4, 5, 6, 7, 8]
    t.insert(ids, [pool.alloc(), pool.alloc()])
    base, got = t.match(ids)
    assert base == 4 and len(got) == 1


def test_tree_divergent_prefixes_fork(pkg):
    pool, t = _tree(pkg)
    a, b = pool.alloc(), pool.alloc()
    t.insert([1, 2, 3, 4, 9], [a])
    t.insert([1, 2, 3, 5, 9], [b])
    assert t.match([1, 2, 3, 4, 8, 8])[1] == [a]
    assert t.match([1, 2, 3, 5, 8, 8])[1] == [b]


def test_tree_eviction_is_lru_and_frees_pages(pkg):
    pool, t = _tree(pkg)
    a, b = pool.alloc(), pool.alloc()
    t.insert([1, 2, 3, 4, 9], [a])
    t.insert([5, 6, 7, 8, 9], [b])
    t.match([1, 2, 3, 4, 9, 9])
    free0 = pool.free_count
    assert t.evict_one()
    assert pool.free_count == free0
    pool.unref(b)
    assert pool.free_count == free0 + 1
    assert t.match([5, 6, 7, 8, 9, 9]) == (0, [])
    assert t.match([1, 2, 3, 4, 9, 9])[1] == [a]


def test_tree_evict_until_free(pkg):
    pool, t = _tree(pkg, pages=8)
    for k in range(3):
        pid = pool.alloc()
        t.insert([10 * k + 1, 10 * k + 2, 10 * k + 3, 10 * k + 4, 0],
                 [pid])
        pool.unref(pid)
    assert pool.free_count == 4
    assert t.evict_until_free(6)
    assert pool.free_count >= 6 and len(t) == 1


# -- the page moves: the JAX functions' arrays -------------------------------
L, P, KH, D, B = 2, 16, 2, 8, 3
PPP = 4  # pages a stream: S = PPP * PS


def _pools(kind):
    """The same random pool, page map and ids in both packages' types."""
    rng = np.random.default_rng(3)
    shape = (L, P, KH, PS, D)
    page_map = rng.permutation(np.arange(1, P))[:B * PPP].reshape(B, PPP)
    page_map[2, 3] = 0  # a sink-padded tail
    if kind == "bf16":
        vals = [rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
                for _ in range(2)]
        jp = JKVCache(k=jnp.asarray(vals[0]), v=jnp.asarray(vals[1]))
        tp = KVCache(*[torch.from_numpy(v.astype(np.float32)).to(
            torch.bfloat16) for v in vals])
    else:
        qs = [rng.integers(-127, 128, shape, dtype=np.int8)
              for _ in range(2)]
        ss = [rng.random(shape[:-1], dtype=np.float32) for _ in range(2)]
        jp = JKVCache(*[JQuantizedKV(q=jnp.asarray(q), scale=jnp.asarray(s))
                        for q, s in zip(qs, ss)])
        tp = KVCache(*[QuantizedKV(torch.from_numpy(q), torch.from_numpy(s))
                       for q, s in zip(qs, ss)])
    return jp, tp, page_map


def _flat(cache, jax_side):
    """Every tensor of a cache as f32 numpy, k then v, codes then
    scales."""
    out = []
    for half in (cache.k, cache.v):
        parts = ([half.q, half.scale]
                 if isinstance(half, (JQuantizedKV, QuantizedKV)) else [half])
        for x in parts:
            out.append(np.asarray(x, np.float32) if jax_side
                       else x.float().numpy())
    return out


def _same(jcache, tcache, skip_sink=False):
    for j, t in zip(_flat(jcache, True), _flat(tcache, False)):
        if skip_sink:
            j, t = j[:, 1:], t[:, 1:]
        np.testing.assert_array_equal(j, t)


def _progs(kind):
    cfg = jtiny(num_hidden_layers=L, num_key_value_heads=KH,
                num_attention_heads=KH * 2, hidden_size=KH * 2 * D)
    plan = MeshPlan.build(cfg, num_stages=1, tp=1, dp=1, sp=1, ep=1)
    return jpool._builders(cfg, plan.mesh,
                           "int8" if kind == "int8" else None)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_page_moves_equal_the_jax_arrays(kind):
    jp, tp, page_map = _pools(kind)
    progs = _progs(kind)
    # the decode dispatch: gather, then write back W pages of each row
    jview = jpool.gather_view(jp, jnp.asarray(page_map))
    tview = tpool.gather_view(tp, torch.from_numpy(page_map))
    _same(jview, tview)
    pos = np.array([5, 17, 30])
    scatter = np.array([[page_map[0, 0], page_map[0, 1]],
                        [page_map[1, 2], page_map[1, 3]],
                        [page_map[2, 3], 0]])
    first = np.minimum(pos // PS, PPP - 2)
    tv2 = KVCache(*[(QuantizedKV(-h.q, h.scale * 2)
                     if isinstance(h, QuantizedKV) else h * 2)
                    for h in (tview.k, tview.v)])
    jv2 = JKVCache(*[(JQuantizedKV(-h.q, h.scale * 2)
                      if isinstance(h, JQuantizedKV) else h * 2)
                     for h in (jview.k, jview.v)])
    jout = jpool.scatter_back(jp, jv2, jnp.asarray(first),
                              jnp.asarray(scatter))
    tpool.scatter_back(tp, tv2, torch.from_numpy(first),
                       torch.from_numpy(scatter))
    _same(jout, tp, skip_sink=True)
    # the staged-row moves
    ids = np.array([page_map[1, 2], page_map[0, 1], 0, 0], np.int32)
    _same(progs["row_gather"](jout, jnp.asarray(ids)),
          tpool.row_gather(tp, ids))
    jrow = progs["row_gather"](jout, jnp.asarray(page_map[0]))
    trow = tpool.row_gather(tp, page_map[0])
    dst = np.array([page_map[2, 0], 0, page_map[1, 1], 0], np.int32)
    jout = progs["row_scatter"](jout, jrow, jnp.asarray(dst))
    tpool.row_scatter(tp, trow, dst)
    _same(jout, tp, skip_sink=True)
    jbatch = jpool.gather_view(jout, jnp.asarray(page_map[:2]))
    tbatch = tpool.gather_view(tp, torch.from_numpy(page_map[:2]))
    bids = np.zeros((2 * PPP,), np.int32)
    bids[[0, 3, 5]] = [page_map[2, 1], page_map[2, 2], page_map[0, 3]]
    jout = progs["batch_scatter"](jout, jbatch, jnp.asarray(bids))
    tpool.batch_scatter(tp, tbatch, bids)
    _same(jout, tp, skip_sink=True)


# -- the engine against the JAX engine ---------------------------------------
@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(), jax.random.PRNGKey(5),
                                 dtype="float32")
    out = {}
    for name, (bits, group, _) in TIERS.items():
        jp = (jparams if bits is None
              else jq.quantize_params(jparams, bits=bits, group_size=group))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _engine(jax_side, params, layout="paged", cfg=None, settings=GREEDY,
            **kw):
    cfg = cfg or (jtiny if jax_side else tiny)(max_seq_len=64,
                                               eos_token_id=-1)
    if jax_side:
        return JBatch(cfg, params, settings=JSettings(**settings),
                      kv_layout=layout, **SMALL, **kw)
    return _Small(cfg, params, settings=SamplerSettings(**settings),
                  kv_layout=layout, device="cpu", **kw)


def _scenario(jax_side, params, block_size, kv_quant, layout="paged",
              settings=GREEDY):
    """Drive one engine through the serving scenario; returns its emitted
    rows as ``(id, end)`` pairs, its counters, its page tables and its
    pool's bookkeeping (the paged layout), each after set_prompts and at
    the end."""
    g = _engine(jax_side, params, layout, settings=settings,
                block_size=block_size, kv_quant=kv_quant,
                **({"kv_page_size": PS} if layout == "paged" else {}))
    g.set_prompts([list(p) for p in PROMPTS])
    paged = layout == "paged"
    books = [(g.stats()["kvpool"], [list(t) for t in g._tables])
             if paged else None]
    rows = [g.step() for _ in range(STEPS[0])]
    retired = g.finish(1)
    for prompt, sid in ARRIVALS:
        g.enqueue(list(prompt), sid)
    rows += [g.step() for _ in range(STEPS[1])]
    ids = [[None if t is None else (t.id, t.is_end_of_stream) for t in row]
           for row in rows]
    st = g.stats()
    if paged:
        books.append((st["kvpool"], [list(t) for t in g._tables]))
    return ids, (retired, st["admit_dispatches"], st["prefix_hits"],
                 st["tokens_emitted"], st["prefix_entries"]), books


CASES = [("f32", 1), ("f32", 4), ("int8+kv8", 4), ("int4g32", 4)]


@pytest.fixture(scope="module")
def jax_runs(weights):
    return {(t, bs): _scenario(True, weights[t][0], bs, TIERS[t][2])
            for t, bs in CASES}


@pytest.mark.parametrize("tier,block_size", CASES)
def test_paged_scenario_matches_jax(weights, jax_runs, tier, block_size):
    want = jax_runs[(tier, block_size)]
    got = _scenario(False, weights[tier][1], block_size, TIERS[tier][2])
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    (kv0, tables0), (kv1, _) = got[2]
    # the prefix's 2 full pages are one physical copy in all 4 tables
    assert kv0["pages_shared"] == 2
    assert len({t[0] for t in tables0}) == 1
    assert len({t[2] for t in tables0}) == 4  # the copy-on-write page
    assert got[1][0] and got[1][2] == 1  # retired, and one prefix hit
    # the edge stream filled its window (an arrival took its slot after)
    col = [row[3] for row in got[0]]
    end = next(i for i, t in enumerate(col) if t is not None and t[1])
    assert sum(1 for t in col[:end + 1] if t is not None) == 64 - 58
    assert kv1["pages_used"] < kv0["pages_total"]


def test_paged_streams_equal_slot_streams_greedy_and_sampled(weights):
    params = weights["f32"][1]
    for settings in (GREEDY, SAMPLED):
        for bs in (1, 4):
            slot = _scenario(False, params, bs, None, "slot", settings)
            paged = _scenario(False, params, bs, None, "paged", settings)
            assert paged[0] == slot[0]
            assert paged[1][:4] == slot[1][:4]


def test_a_write_never_reaches_a_shared_prefix_page(weights):
    """Two streams share the prefix's pages; one retires mid-run while the
    other decodes on: the shared pages keep their bits and the survivor
    emits the ids of the run where nothing retired."""
    params = weights["f32"][1]
    prompts = [PREFIX + [5, 9, 2], PREFIX + [3, 1, 4, 1]]
    ref = _engine(False, params, kv_page_size=PS)
    ref.set_prompts(prompts)
    want = ref.generate(13)[1]
    g = _engine(False, params, kv_page_size=PS)
    g.set_prompts(prompts)
    shared = g._tables[0][:2]
    assert shared == g._tables[1][:2]
    before = [x[:, shared].clone() for x in tpool.halves(g.cache)]
    g.generate(3)
    g.finish(0)
    assert g.stats()["kvpool"]["pages_shared"] == 2  # the tree's claim
    assert g.generate(10)[1] == want
    for x, y in zip(before, tpool.halves(g.cache)):
        assert torch.equal(x, y[:, shared])


def test_constrained_stream_rides_paged_like_jax(weights):
    vocab = [chr(48 + i % 10) for i in range(jtiny().vocab_size)]
    outs = {}
    for jax_side, (guide_cls, build) in ((True, (JGuide, jbuild_dfa)),
                                         (False, (Guide, build_token_dfa))):
        cfg = (jtiny if jax_side else tiny)(max_seq_len=64, eos_token_id=2)
        g = _engine(jax_side, weights["f32"][0 if jax_side else 1],
                    cfg=cfg, kv_page_size=PS)
        guide = guide_cls(build("[0-9]{3};?", vocab, eos_ids=(2,)))
        g.set_prompts([[5, 6, 7], [8, 9, 10]], guides=[None, guide])
        out = g.generate(6)
        g.finish(0)
        g.enqueue([11, 12, 13], 9, guide=guide_cls(
            build("[0-9]{2}", vocab, eos_ids=(2,))))
        for _ in range(12):
            g.step()
        outs[jax_side] = (out, {s.stream_id: list(s.generated)
                                for s in g.streams})
    assert outs[False] == outs[True]


def _pressure(jax_side, params):
    """A minimum pool (2 streams x 4 pages + sink -> 16 at page size 16):
    seven distinct 37-id arrivals fill the prefix tree until it evicts;
    then a live stream's three exported snapshots, begun as imports, pin
    9 pages, and a 50-id arrival defers until the imports abort."""
    g = _engine(jax_side, params, kv_page_size=16, kv_pool_pages=16)
    g.set_prompts([[1], [1]])
    for s in g.streams:
        s.done = True
    out = {}

    def drive(sid, n):
        for _ in range(200):
            s = next((s for s in g.streams if s.stream_id == sid
                      and not s.done), None)
            if s is not None and len(s.generated) >= n \
                    and not g.pending_admissions():
                return list(s.generated[:n])
            g.step()
        raise AssertionError(f"stream {sid} stalled")

    for k in range(7):
        g.enqueue([k + 100] + LONG[:34] + [k, 9], 10 + k)
        out[10 + k] = drive(10 + k, 3)
        g.finish(10 + k)
    g.enqueue([99] + LONG[:34] + [7, 7], 20)
    drive(20, 2)
    xids = []
    for _ in range(3):
        meta = g.import_begin(g.export_stream(20))
        xids.append(meta["xfer_id"])
    defers0 = g._pagepool._defer_ctr.value
    g.enqueue([98] + LONG[:49], 21)
    for _ in range(6):
        g.step()
    deferred = g._pagepool._defer_ctr.value - defers0
    assert not any(s.stream_id == 21 for s in g.streams)
    for x in xids:
        assert g.import_abort(x)
    out[21] = drive(21, 4)
    out[20] = drive(20, 8)
    return out, deferred, g._pagepool._evict_ctr.value, g._pagepool.stats()


def test_pool_pressure_evicts_and_defers_like_jax(weights):
    want = _pressure(True, weights["f32"][0])
    got = _pressure(False, weights["f32"][1])
    assert got == want
    assert got[1] == 1 and got[2] > 0


@pytest.mark.parametrize("kw,call", [
    (dict(kv_layout="paged", spec_k=4), None),
    (dict(kv_layout="paged", kv_page_size=7), None),
    (dict(kv_layout="blocks"), None),
    (dict(kv_layout="paged", kv_pool_pages=100), None),
    (dict(kv_layout="paged", kv_pool_pages=8), "set_prompts"),
    (dict(), "export_stream"),
])
def test_validation_speaks_the_jax_messages(weights, kw, call):
    msgs = []
    for jax_side in (True, False):
        cfg = (jtiny if jax_side else tiny)(max_seq_len=64)
        params = weights["f32"][0 if jax_side else 1]
        with pytest.raises(ValueError) as exc:
            if jax_side:
                g = JBatch(cfg, params, **kw)
            else:
                g = BatchGenerator(cfg, params, device="cpu", **kw)
            if call == "set_prompts":
                g.set_prompts([[5, 9, 2], [3, 1], [7]])
            elif call == "export_stream":
                g.set_prompts([[5, 9, 2]])
                g.export_stream(0)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]
