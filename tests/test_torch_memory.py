"""The port's per-rank memory budget (``utils/memory.py hbm_budget``)
against the JAX package's, and the card spec table (``utils/chips.py``).

The budget is pure arithmetic: the port's must give the JAX function's
bytes, key for key, on every layout both packages take, and price the
port's own tensors (the weights ``init_params*`` draws, the cache
``init_cache`` makes) byte for byte.
"""

import itertools

import pytest
import torch

from cake_tpu.models import config as jconfig
from cake_tpu.utils.memory import hbm_budget as jbudget
from cake_tpu_torch.models import config
from cake_tpu_torch.models import llama
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.utils import chips
from cake_tpu_torch.utils.memory import hbm_budget

PRESETS = ("llama3_8b", "llama3_70b", "mixtral_8x7b")
QUANTS = (None, "int8", "int4", "int4:g128")


@pytest.mark.parametrize("quant", QUANTS, ids=str)
@pytest.mark.parametrize("preset", PRESETS)
def test_budget_equals_the_jax_packages(preset, quant):
    cfg = getattr(config, preset)()
    jcfg = getattr(jconfig, preset)()
    eps = (1, 2) if preset.startswith("mixtral") else (1,)
    n = 0
    for stages, tp, sp, ep, el, batch, max_seq in itertools.product(
            (1, 2, 4, 16), (1, 2, 4, 8), (1, 2), eps, (1, 2), (1, 8),
            (None, 8192)):
        kw = dict(num_stages=stages, tp=tp, sp=sp, ep=ep, max_seq=max_seq,
                  batch=batch, quant=quant, cache_bytes_per_el=el)
        assert hbm_budget(cfg, **kw) == jbudget(jcfg, **kw), kw
        n += 1
    assert n == 4 * 4 * 2 * len(eps) * 2 * 2 * 2


def test_int4_groups_off_the_k16_step_are_refused():
    """The JAX package prices any even group; the port's loader refuses
    groups that are not a multiple of 16, and so does its budget."""
    cfg = config.llama3_8b()
    jbudget(jconfig.llama3_8b(), quant="int4:g8")
    with pytest.raises(ValueError, match="multiple of 16"):
        hbm_budget(cfg, quant="int4:g8")
    assert hbm_budget(cfg, quant="int4:g32") == jbudget(
        jconfig.llama3_8b(), quant="int4:g32")


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(t) for t in vars(tree).values())


@pytest.mark.parametrize("quant", [None, "int8", "int4", "int4:g16"],
                         ids=str)
def test_budget_prices_the_ports_tensors(quant):
    cfg = config.tiny(num_hidden_layers=3, max_seq_len=32)
    kind, group = (quant or "").partition(":g")[::2]
    if quant is None:
        p = llama.init_params(cfg, device="cpu")
    elif kind == "int8":
        p = llama.init_params_int8(cfg, device="cpu")
    else:
        p = llama.init_params_int4(cfg, device="cpu",
                                   group_size=int(group) if group else None)
    el = torch.empty((), dtype=cfg.torch_dtype).element_size()
    b = hbm_budget(cfg, quant=quant, batch=2, max_seq=32,
                   cache_bytes_per_el=el)
    assert b["layers"] == _nbytes(p["layers"])
    assert b["embed_replicated"] == _nbytes(p["embed"])
    assert b["head"] == _nbytes(p["lm_head"]) + _nbytes(p["norm_f"])
    cache = init_cache(cfg, batch=2, max_seq=32, device="cpu")
    assert b["kv_cache"] == _nbytes(cache.k) + _nbytes(cache.v)
    q8 = init_cache(cfg, batch=2, max_seq=32, device="cpu", quant="int8")
    assert hbm_budget(cfg, quant=quant, batch=2, max_seq=32,
                      cache_bytes_per_el=1)["kv_cache"] == (
        _nbytes(q8.k) + _nbytes(q8.v))


def test_the_h100_row():
    assert chips.PEAK_BYTES_PER_S == 3.35e12
    assert chips.PEAK_BF16_FLOPS == 989e12
    assert chips.device_spec("cpu", chips.HBM_GBPS, 1.0) == 1.0
    assert chips.device_name("cpu") == "cpu"
    assert chips.hbm_gbps("cpu") == 3350.0
