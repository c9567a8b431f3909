"""The port's stream snapshots (``cake_tpu_torch/disagg/snapshot.py`` and the
paged engine's ``export_stream``/``import_stream``) against the JAX
package's.

- ``encode_snapshot`` of both packages gives the same bytes for the same
  fields and pages: a bf16 pool and an int8 pool, under each codec;
  ``decode_snapshot`` of each reads the other's;
- a stream exported by the JAX paged engine imports into the port's and
  continues with the JAX engine's greedy ids, and the reverse (both from
  the same f32 weights, ``tiny(max_seq_len=64)``, page size 16);
- the port's own round trips are bit-identical: greedy, sampled (under
  another seed and stream id: the snapshot's key decides the noise),
  mid-page, constrained mid-grammar, the int8 pool under the int8 codec
  and a bf16 cache under the bf16 codec;
- fingerprint mismatches are refused, imports are idempotent by transfer
  id, export needs a live stream and the paged layout; an import into a
  full pool defers FIFO-fair, ``import_abort`` and ``expire_imports``
  release its pins, and an eviction storm cannot free pinned pages.

Exact equality throughout: bytes, ids, page tensors.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from cake_tpu.disagg import snapshot as jsnap
from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu_torch.constrain import guide_for
from cake_tpu_torch.disagg import snapshot as tsnap
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import init_params, params_from_jax
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator

GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, top_p=0.95, repeat_penalty=1.1, seed=123)
L, KH, PS, D = 2, 2, 8, 4


class _FakeTok:
    """id -> letter."""

    def decode(self, ids):
        return "".join(chr(ord("a") + (i % 26)) for i in ids)

    def encode(self, text):
        return [ord(c) - ord("a") for c in text]


# -- the format --------------------------------------------------------------
def _pages(kind, n=2):
    """``n`` pages of a bf16 or int8 pool from a numpy seed, as the JAX
    engine holds them (numpy, ml_dtypes bf16) and as the port's does
    (CPU tensors)."""
    rng = np.random.default_rng(11)
    jp, tp = [], []
    for _ in range(n):
        if kind == "bf16":
            k, v = (rng.standard_normal((L, KH, PS, D)).astype(
                ml_dtypes.bfloat16) for _ in range(2))
            jp.append({"k": k, "v": v})
            tp.append({n_: torch.from_numpy(a.astype(np.float32)).to(
                torch.bfloat16) for n_, a in (("k", k), ("v", v))})
        else:
            d = {"kq": rng.integers(-127, 128, (L, KH, PS, D), np.int8),
                 "ks": rng.random((L, KH, PS), np.float32),
                 "vq": rng.integers(-127, 128, (L, KH, PS, D), np.int8),
                 "vs": rng.random((L, KH, PS), np.float32)}
            jp.append(d)
            tp.append({n_: torch.from_numpy(a) for n_, a in d.items()})
    return jp, tp


def _fields(codec, pages, **over):
    kw = dict(xfer_id="x-1", fingerprint={"layers": L, "dtype": "bfloat16",
                                          "kv_quant": None},
              codec=codec, stream_id=3, prompt=[1, 2, 3],
              generated=[9, 8, 7], pos=10, index=3, last_token=7,
              key=[0x12345678, 0x9ABCDEF0], history=np.full(8, -1, np.int32),
              hist_slot=3, guide_spec={"type": "regex", "pattern": "a+"},
              guide_state=2, pages=pages,
              trace={"id": "t", "parent": "p", "request": "r"})
    kw.update(over)
    return kw


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_encode_gives_the_jax_bytes(kind, codec):
    jp, tp = _pages(kind)
    want = jsnap.encode_snapshot(**_fields(codec, jp))
    got = tsnap.encode_snapshot(**_fields(codec, tp))
    assert got == want


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_each_package_decodes_the_others(kind):
    jp, tp = _pages(kind, n=3)
    jdata = jsnap.encode_snapshot(**_fields("none", jp))
    tdata = tsnap.encode_snapshot(**_fields("none", tp))
    a, b = tsnap.decode_snapshot(jdata), jsnap.decode_snapshot(tdata)
    for s in (a, b):
        assert (s.xfer_id, s.stream_id, s.pos, s.index, s.last_token,
                s.hist_slot, s.guide_state) == ("x-1", 3, 10, 3, 7, 3, 2)
        assert s.prompt == [1, 2, 3] and s.generated == [9, 8, 7]
        assert list(s.key) == [0x12345678, 0x9ABCDEF0]
        assert s.guide_spec == {"type": "regex", "pattern": "a+"}
        assert s.trace == {"id": "t", "parent": "p", "request": "r"}
    for pa, pb, pj in zip(a.pages, b.pages, jp):
        for name, arr in pj.items():
            np.testing.assert_array_equal(
                pa[name].float().numpy(), np.asarray(arr, np.float32))
            np.testing.assert_array_equal(np.asarray(pb[name], np.float32),
                                          np.asarray(arr, np.float32))
    assert tsnap.peek_xfer_id(jdata) == jsnap.peek_xfer_id(tdata) == "x-1"


def test_bad_bytes_are_refused():
    data = tsnap.encode_snapshot(**_fields("none", _pages("bf16")[1]))
    for bad, match in ((b"XXXX" + data[4:], "magic"),
                       (data[:4] + b"\x09\x00" + data[6:], "version"),
                       (data[:-3], "truncated"), (data + b"\x00", "trailing")):
        with pytest.raises(tsnap.SnapshotError, match=match):
            tsnap.decode_snapshot(bad)


# -- the engines -------------------------------------------------------------
CFG = dict(max_seq_len=64, eos_token_id=-1)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(11),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _gen(params, jax_side=False, pool=None, quant=None, tokenizer=None,
         cfg=None, settings=GREEDY):
    kw = {"kv_pool_pages": pool} if pool else {}
    if jax_side:
        return JBatch(cfg or jtiny(**CFG), params, tokenizer=tokenizer,
                      settings=JSettings(**settings), kv_layout="paged",
                      kv_page_size=16, kv_quant=quant, **kw)
    return BatchGenerator(cfg or tiny(**CFG), params, tokenizer=tokenizer,
                          settings=SamplerSettings(**settings),
                          kv_layout="paged", kv_page_size=16, kv_quant=quant,
                          device="cpu", **kw)


def _tokens(gen, sid):
    for s in gen.streams:
        if getattr(s, "active", True) and not s.done and s.stream_id == sid:
            return list(s.generated)
    return None


def _drive(gen, sid, want, max_steps=400):
    """step() until stream ``sid`` holds ``want`` tokens; returns them."""
    for _ in range(max_steps):
        got = _tokens(gen, sid)
        if got is not None and len(got) >= want \
                and not gen.pending_admissions():
            return got[:want]
        gen.step()
    raise AssertionError(f"stream {sid} never reached {want} tokens")


def _retire_all(gen):
    for s in list(gen.streams):
        if getattr(s, "active", True) and not s.done:
            gen.finish(s.stream_id)


def _export_after(gen, sid, n_tokens, codec="none"):
    _drive(gen, sid, n_tokens)
    return gen.export_stream(sid, codec=codec)


def _import_fresh(params, snap, sid=7, jax_side=False, **gen_kw):
    """A new engine with retired streams, the snapshot attached as
    ``sid``."""
    g = _gen(params, jax_side, **gen_kw)
    g.set_prompts([[9, 9], [8, 8]])
    _retire_all(g)
    g.import_stream(snap, stream_id=sid)
    return g


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_a_stream_moves_between_the_packages(weights, exporter):
    """Exported mid-page by one package's engine, imported by the other's
    under another stream id: the greedy continuation is the exporter's
    uninterrupted one."""
    jp, tp = weights
    src_jax = exporter == "jax"
    a = _gen(jp if src_jax else tp, src_jax)
    a.set_prompts([list(range(1, 21)), [5, 6, 7]])
    snap = _export_after(a, 0, 5)
    ref = _drive(a, 0, 16)
    b = _import_fresh(tp if src_jax else jp, snap, jax_side=not src_jax)
    assert _drive(b, 7, 16) == ref


def test_the_fingerprints_and_page_shapes_are_the_jax_engines(weights):
    jp, tp = weights
    for quant in (None, "int8"):
        j, t = _gen(jp, True, quant=quant), _gen(tp, quant=quant)
        assert t._disagg_fingerprint() == j._disagg_fingerprint()
        assert {k: (s, str(d).removeprefix("torch."))
                for k, (s, d) in t._page_shapes().items()} == \
            {k: (s, d.name) for k, (s, d) in j._page_shapes().items()}


def test_round_trip_greedy(weights):
    a = _gen(weights[1])
    a.set_prompts([[1, 2, 3, 4], [5, 6, 7]])
    snap = _export_after(a, 0, 5)
    ref = _drive(a, 0, 16)
    assert _drive(_import_fresh(weights[1], snap), 7, 16) == ref


def test_round_trip_sampled_under_another_seed(weights):
    a = _gen(weights[1], settings=SAMPLED)
    a.set_prompts([[1, 2, 3, 4], [5, 6, 7]])
    snap = _export_after(a, 0, 5)
    s = tsnap.decode_snapshot(snap)
    assert list(s.key) == sampling.stream_key(SAMPLED["seed"], 0)
    ref = _drive(a, 0, 16)
    b = _import_fresh(weights[1], snap, settings=dict(SAMPLED, seed=999))
    assert _drive(b, 7, 16) == ref


def test_round_trip_mid_window_multi_page(weights):
    a = _gen(weights[1])
    a.set_prompts([list(range(1, 21)), [5, 6, 7]])
    snap = _export_after(a, 0, 3)
    s = tsnap.decode_snapshot(snap)
    assert s.n_pages == 2 and s.pos == 22
    ref = _drive(a, 0, 12)
    assert _drive(_import_fresh(weights[1], snap), 7, 12) == ref


def test_round_trip_constrained_mid_grammar(weights):
    tok = _FakeTok()
    spec = {"type": "regex", "pattern": "[a-d]{30}"}
    a = _gen(weights[1], tokenizer=tok)
    a.set_prompts([[1, 2, 3], [4, 5]],
                  guides=[guide_for(spec, tok, tiny(**CFG)), None])
    snap = _export_after(a, 0, 4)
    parsed = tsnap.decode_snapshot(snap)
    assert parsed.guide_spec == spec and parsed.guide_state != 0
    ref = _drive(a, 0, 12)
    got = _drive(_import_fresh(weights[1], snap, tokenizer=tok), 7, 12)
    assert got == ref
    assert all(c in "abcd" for c in tok.decode(got))


def test_round_trip_int8_pool_int8_codec(weights):
    a = _gen(weights[1], quant="int8")
    a.set_prompts([[1, 2, 3, 4], [5, 6, 7]])
    snap = _export_after(a, 0, 5, codec="int8")
    ref = _drive(a, 0, 14)
    assert _drive(_import_fresh(weights[1], snap, quant="int8"), 7,
                  14) == ref


def test_round_trip_bf16_cache_bf16_codec():
    cfg = tiny(**CFG, dtype="bfloat16")
    p16 = init_params(cfg, device="cpu")
    a = _gen(p16, cfg=cfg)
    a.set_prompts([[1, 2, 3, 4], [5, 6, 7]])
    snap = _export_after(a, 0, 5, codec="bf16")
    ref = _drive(a, 0, 14)
    assert _drive(_import_fresh(p16, snap, cfg=cfg), 7, 14) == ref


def test_fingerprint_mismatch_refused(weights):
    a = _gen(weights[1])
    a.set_prompts([[1, 2, 3, 4]])
    snap = _export_after(a, 0, 3)
    b = BatchGenerator(tiny(**CFG), weights[1], kv_layout="paged",
                       kv_page_size=8, device="cpu")
    b.set_prompts([[1]])
    _retire_all(b)
    with pytest.raises(tsnap.SnapshotMismatch, match="page_size"):
        b.import_begin(snap)


def test_import_idempotent_by_xfer_id(weights):
    a = _gen(weights[1])
    a.set_prompts([[1, 2, 3, 4]])
    snap = _export_after(a, 0, 3)
    b = _gen(weights[1])
    b.set_prompts([[9, 9]])
    _retire_all(b)
    assert b.import_begin(snap)["xfer_id"] == b.import_begin(snap)["xfer_id"]
    assert b.imports_pending() == 1


def test_export_requires_live_stream_and_paged(weights):
    g = _gen(weights[1])
    g.set_prompts([[1, 2, 3]])
    with pytest.raises(ValueError, match="no live stream"):
        g.export_stream(99)
    slot = BatchGenerator(tiny(**CFG), weights[1], device="cpu")
    slot.set_prompts([[1, 2, 3]])
    with pytest.raises(ValueError, match="paged"):
        slot.export_stream(0)


# -- pool pressure: FIFO-fair deferral and pinned pages -----------------------
def test_import_into_full_pool_defers_fifo_fair(weights):
    a = _gen(weights[1])
    a.set_prompts([[1] * 40])
    snap = _export_after(a, 0, 12)  # pos 52: a 4-page snapshot
    b = _gen(weights[1], pool=16)
    b.set_prompts([[1] * 40, [2] * 40, [3] * 40])
    for sid in (0, 1, 2):
        _drive(b, sid, 12)
    defers0 = b._pagepool._defer_ctr.value
    b.import_begin(snap)
    b.import_attach(tsnap.peek_xfer_id(snap), 7)
    b.enqueue([5, 6, 7], 9)  # a prompt queued behind it
    for _ in range(6):
        b.step()
    assert b.imports_pending() == 1
    assert b.pending_admissions() == 3
    assert b._pagepool._defer_ctr.value == defers0 + 1
    ref = _drive(a, 0, 18)
    b.finish(2)
    assert _drive(b, 7, 18) == ref
    b.finish(0)
    assert _drive(b, 9, 2)


def test_import_stream_foreign_blocked_head_raises(weights):
    a = _gen(weights[1])
    a.set_prompts([[1, 2, 3, 4], [5, 6]])
    snap = _export_after(a, 0, 3)
    b = _gen(weights[1])
    b.set_prompts([[9, 9], [8, 8]])
    b.enqueue([7, 7, 7], 50)
    with pytest.raises(RuntimeError, match="no free slot"):
        b.import_stream(snap, stream_id=7)
    assert b.imports_pending() == 0


def test_evict_storm_cannot_free_pinned_pages(weights):
    a = _gen(weights[1])
    a.set_prompts([list(range(1, 21)), [5, 6]])
    snap = _export_after(a, 0, 4)
    ref = _drive(a, 0, 12)
    b = _gen(weights[1], pool=16)
    b.set_prompts([[7, 7, 7], [6, 6]])
    _retire_all(b)
    b.import_begin(snap)
    xid = tsnap.peek_xfer_id(snap)
    for _ in range(8):
        b.step()
        if b._imports[xid]["pages"] is not None:
            break
    pinned = list(b._imports[xid]["pages"])
    assert pinned and all(b._pagepool.pincount(p) == 1 for p in pinned)
    evicted0 = b._pagepool._evict_ctr.value
    # eight 36-id arrivals: their prefix pages outgrow the pool
    for i in range(8):
        b.enqueue([i + 1] * 36, 100 + i)
        _drive(b, 100 + i, 8)
        b.finish(100 + i)
    assert b._pagepool._evict_ctr.value > evicted0
    assert all(b._pagepool.pincount(p) == 1 for p in pinned)
    for i, s in enumerate(b.streams):
        if not s.done:
            assert not set(pinned) & set(b._tables[i])
    b.import_attach(xid, 7)
    assert _drive(b, 7, 12) == ref


def test_import_abort_and_expiry_release_pins(weights):
    a = _gen(weights[1])
    a.set_prompts([[1, 2, 3, 4]])
    snap = _export_after(a, 0, 3)
    b = _gen(weights[1])
    b.set_prompts([[9, 9]])
    _retire_all(b)
    b.import_begin(snap)
    xid = tsnap.peek_xfer_id(snap)
    for _ in range(8):
        b.step()
        if b._imports[xid]["pages"] is not None:
            break
    free0 = b._pagepool.free_count
    assert b.import_abort(xid)
    assert b._pagepool.free_count > free0
    assert b._pagepool.pinned_count == 0
    assert not b.import_abort(xid)
    b.import_begin(_export_after(a, 0, 5))
    assert b.expire_imports(ttl_s=3600) == 0
    assert b.expire_imports(ttl_s=0.0) == 1
    assert b.imports_pending() == 0
