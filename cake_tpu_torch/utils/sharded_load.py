"""Direct-to-rank checkpoint loading: each rank reads its own shard's bytes
(port of ``cake_tpu/utils/sharded_load.py``).

:func:`load_llama_params_on_mesh` builds one rank's params tree, the
layout :func:`~cake_tpu_torch.parallel.mesh.shard_params` gives, straight
from the memory-mapped safetensors files (:class:`CheckpointReader`): a
rank of stage ``s`` reads only its stage's layers, a tp rank only its
slice of each sharded linear, an ep rank only its run of a Mixtral
layer's experts (codes and scales alike, ``.q8`` checkpoints too). There is never a full-model copy, on the
host or on the card. It is byte for byte the JAX loader's addressable
shard of the same rank's device.

Quantize-on-load (``"int8"``/``"int4"``) stays shard-local where the math
allows: column-parallel linears (``wq/wk/wv/w_gate/w_up`` and the head)
keep the full in-axis, which is all a per-output-channel scale depends on,
so quantizing the column slice equals quantizing the full weight and
slicing. A row-parallel linear (``wo``, ``w_down``) reads the full layer
weight for its scale, quantizes and keeps its rows, one layer at a time.
Int4 shards the packed rows, which adjacent-pair packing keeps contiguous
original rows. Pre-quantized ``.q8``/``.q4`` checkpoints are read per
shard, grouped int4 scales among them; grouped int4 quantize-on-load is
refused, as in the JAX package (pre-quantize once instead).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.quant import (
    Quantized4Linear,
    QuantizedLinear,
    pack_int4_np,
    parse_quant_spec,
    quantize_linear4_np,
    quantize_linear_np,
    reject_int4_moe,
)
from cake_tpu_torch.parallel.mesh import MeshPlan, shard_slice
from cake_tpu_torch.utils.device import resolve_device
from cake_tpu_torch.utils.safetensors import SafetensorsFile
from cake_tpu_torch.utils.weights import (
    _BIAS_MAP,
    _LAYER_MAP,
    _MOE_EXPERT_MAP,
    _MOE_ROUTER,
    check_prequantized,
    detect_family,
    detect_tied_head,
    hf_layer_map,
    load_safetensors_index,
)

# column-parallel: out-features shard over tp, in-axis full per shard
_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
# row-parallel: in-features shard over tp (scale needs the full in-axis)
_ROW_PARALLEL = ("wo", "w_down")
_ALL = slice(None)


class CheckpointReader:
    """Sliced reads over a safetensors checkpoint's memory maps, with
    byte accounting (``bytes_read``: a stage reads ~1/S of the model)."""

    def __init__(self, model_dir: str | Path):
        self.name_to_file = load_safetensors_index(model_dir)
        self._files: dict[Path, SafetensorsFile] = {}
        self._maps: dict = {}
        self.bytes_read = 0

    def _slice(self, name: str):
        m = self._maps.get(name)
        if m is None:
            f = self.name_to_file[name]
            if f not in self._files:
                self._files[f] = SafetensorsFile(f)
            m = self._maps[name] = self._files[f].sliceable(name)
        return m

    def _count(self, t: torch.Tensor) -> torch.Tensor:
        self.bytes_read += t.numel() * t.element_size()
        return t

    def read1d(self, name: str, sl: slice = _ALL) -> torch.Tensor:
        return self._count(self._slice(name).read((sl,)))

    def read2d(self, name: str, rows: slice, cols: slice,
               transpose: bool) -> torch.Tensor:
        """Logical ``[rows, cols]`` slice; ``transpose=True`` when the
        checkpoint stores the HF ``[out, in]`` layout and the logical one
        is ``[in, out]``."""
        if transpose:
            return self._count(self._slice(name).read((cols, rows))).t()
        return self._count(self._slice(name).read((rows, cols)))

    def shape(self, name: str) -> tuple:
        """Stored shape, without reading tensor bytes."""
        return self._slice(name).shape

    def close(self) -> None:
        self._maps.clear()
        self._files.clear()


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def load_llama_params_on_mesh(model_dir: str | Path, config: LlamaConfig,
                              plan: MeshPlan, rank: int,
                              quantize: str | None = None, device=None,
                              tie_word_embeddings: bool = False) -> dict:
    """Rank ``rank``'s shard of the checkpoint in ``model_dir`` (the layout
    of :func:`~cake_tpu_torch.parallel.mesh.param_specs`), on ``device``
    (the card unless the CPU is asked for). Reads only the rank's bytes,
    plus, for a row-parallel linear quantized on load, its full layer
    weight (one at a time). Equal, leaf for leaf, to
    ``shard_params(load_llama_params(...), plan, rank)``."""
    dev = resolve_device(device)
    tier, gsize = parse_quant_spec(quantize)
    int4 = tier == "int4"
    qsuffix = ".q4" if int4 else ".q8"
    np_qfn = quantize_linear4_np if int4 else quantize_linear_np
    qcls = Quantized4Linear if int4 else QuantizedLinear
    qmax = 7 if int4 else 127
    krows = 2 if int4 else 1  # original rows per stored quantized row
    coords = plan.coords(rank)
    tp, t_idx = plan.tp, coords["tp"]
    L = config.num_hidden_layers
    lay = shard_slice(L, plan.num_stages, coords["stage"])
    layer_ids = range(lay.start, lay.stop)
    h = config.hidden_size
    d = config.head_dim
    dt = config.torch_dtype

    def tsl(n: int) -> slice:
        return shard_slice(n, tp, t_idx)

    reader = CheckpointReader(model_dir)
    num_experts, attention_bias, o_bias = detect_family(reader.name_to_file)
    if not tie_word_embeddings and detect_tied_head(reader.name_to_file,
                                                    model_dir):
        tie_word_embeddings = True
    if num_experts and int4:
        reject_int4_moe()
    prequantized = check_prequantized(reader.name_to_file, quantize)
    group = None  # in-rows per scale group, read off the checkpoint
    if int4 and prequantized:
        probe = f"model.layers.0.{_LAYER_MAP['wq'][0]}.scale"
        if probe in reader.name_to_file:
            sshape = reader.shape(probe)
            if len(sshape) == 2:
                group = h // sshape[0]
    if gsize is not None and not prequantized:
        raise ValueError(
            "grouped int4 quantize-on-load is not supported on the "
            "direct-to-mesh path; pre-quantize once with `python -m "
            "cake_tpu_torch.tools.quantize_model --bits 4 --group-size "
            f"{gsize}` and load that checkpoint")
    if gsize is not None and gsize != group:
        raise ValueError(
            f"checkpoint stores "
            f"{'group_size=' + str(group) if group else 'per-channel'} "
            f"int4, but quantize spec asked for g{gsize}")
    dims = {
        "wq": (h, config.num_attention_heads * d),
        "wk": (h, config.num_key_value_heads * d),
        "wv": (h, config.num_key_value_heads * d),
        "wo": (config.num_attention_heads * d, h),
        "w_gate": (h, config.intermediate_size),
        "w_up": (h, config.intermediate_size),
        "w_down": (config.intermediate_size, h),
    }

    def put(t: torch.Tensor, cast: bool = True) -> torch.Tensor:
        t = t.contiguous()
        return t.to(device=dev, dtype=dt if cast else t.dtype)

    def stack(read) -> torch.Tensor:
        return torch.stack([read(i) for i in layer_ids])

    def quant_one(name: str, transpose: bool, kdim: int, ndim: int,
                  row_parallel: bool) -> tuple[np.ndarray, np.ndarray]:
        """(codes, scale) of this rank's shard of one linear ``[kdim,
        ndim]`` stored under ``name``."""
        rows = tsl(kdim) if row_parallel else _ALL
        cols = _ALL if row_parallel else tsl(ndim)
        if prequantized:
            packed = (shard_slice(kdim // krows, tp, t_idx)
                      if row_parallel else _ALL)
            q = reader.read2d(f"{name}{qsuffix}", packed, cols, True)
            if group is not None:
                g_rows = (shard_slice(kdim // group, tp, t_idx)
                          if row_parallel else _ALL)
                s = reader.read2d(f"{name}.scale", g_rows, cols, False)
            else:
                s = reader.read1d(f"{name}.scale", cols)
            return q.numpy(), s.numpy()
        if row_parallel:
            s = np_qfn(_f32(reader.read2d(name, _ALL, cols, transpose)))[1]
            w = _f32(reader.read2d(name, rows, cols, transpose))
            q = np.clip(np.round(w / s), -qmax, qmax).astype(np.int8)
            return (pack_int4_np(q) if int4 else q), s
        return np_qfn(_f32(reader.read2d(name, rows, cols, transpose)))

    def quant_stack(names, transpose: bool, kdim: int, ndim: int,
                    row_parallel: bool):
        qs, ss = zip(*(quant_one(n, transpose, kdim, ndim, row_parallel)
                       for n in names))
        return qcls(torch.from_numpy(np.ascontiguousarray(np.stack(qs))
                                     ).to(dev),
                    torch.from_numpy(np.ascontiguousarray(np.stack(ss))
                                     ).to(dev))

    try:
        layers: dict = {}
        for ours, (suffix, transpose) in hf_layer_map(
                num_experts, attention_bias, o_bias).items():
            def name(i, sfx=suffix):
                return f"model.layers.{i}.{sfx}"

            if ours == "bo" or ours.endswith("norm"):
                layers[ours] = put(stack(lambda i: reader.read1d(name(i))))
            elif ours in _BIAS_MAP:
                out = dims[ours.replace("b", "w", 1)][1]
                layers[ours] = put(stack(
                    lambda i: reader.read1d(name(i), tsl(out))))
            else:
                kdim, ndim = dims[ours]
                row = ours in _ROW_PARALLEL
                if tier is not None:
                    layers[ours] = quant_stack(
                        [name(i) for i in layer_ids], transpose, kdim, ndim,
                        row)
                else:
                    rows = tsl(kdim) if row else _ALL
                    cols = _ALL if row else tsl(ndim)
                    layers[ours] = put(stack(lambda i: reader.read2d(
                        name(i), rows, cols, transpose)))

        if num_experts:
            # router [L, H, E]: replicated (every rank routes every
            # token); expert stacks [L, E, in, out]: the rank's run of
            # experts over ep, every expert's features over tp like the
            # dense MLP
            layers["router"] = put(stack(lambda i: reader.read2d(
                f"model.layers.{i}.{_MOE_ROUTER}", _ALL, _ALL, True)))
            fdim = config.intermediate_size
            experts = shard_slice(num_experts, plan.ep, coords["ep"])
            for ours, (kdim, ndim) in {"w_gate": (h, fdim),
                                       "w_up": (h, fdim),
                                       "w_down": (fdim, h)}.items():
                pattern = _MOE_EXPERT_MAP[ours]
                row = ours == "w_down"
                names = [[f"model.layers.{i}.{pattern.format(e=e)}"
                          for e in range(experts.start, experts.stop)]
                         for i in layer_ids]
                if tier is not None:
                    per = [quant_stack(n, True, kdim, ndim, row)
                           for n in names]
                    layers[ours] = qcls(torch.stack([p.q for p in per]),
                                        torch.stack([p.scale for p in per]))
                else:
                    rows = tsl(kdim) if row else _ALL
                    cols = _ALL if row else tsl(ndim)
                    layers[ours] = put(torch.stack([torch.stack([
                        reader.read2d(n, rows, cols, True) for n in row_n])
                        for row_n in names]))

        embed_name = "model.embed_tokens.weight"
        head_name = embed_name if tie_word_embeddings else "lm_head.weight"
        params: dict = {"layers": layers}
        params["embed"] = put(reader.read2d(embed_name, _ALL, _ALL, False))
        params["norm_f"] = put(reader.read1d("model.norm.weight"))
        vcols = tsl(config.vocab_size)
        if tier is not None:
            head_prequant = (prequantized and f"{head_name}{qsuffix}"
                             in reader.name_to_file)
            if head_prequant:
                q, s = quant_one(head_name, True, h, config.vocab_size,
                                 False)
            elif group is not None:
                # a tied head of a grouped checkpoint: quantized here at
                # the checkpoint's group size, as the JAX loader does
                q, s = quantize_linear4_np(
                    _f32(reader.read2d(head_name, _ALL, vcols, True)),
                    group_size=group)
            else:
                q, s = np_qfn(_f32(reader.read2d(head_name, _ALL, vcols,
                                                 True)))
            params["lm_head"] = qcls(
                torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                torch.from_numpy(np.ascontiguousarray(s)).to(dev))
        else:
            params["lm_head"] = put(reader.read2d(head_name, _ALL, vcols,
                                                  True))
        return params
    finally:
        reader.close()
