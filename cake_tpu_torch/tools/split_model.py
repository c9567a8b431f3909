"""split-model: pre-split a checkpoint into per-worker bundles (port of
``cake_tpu/tools/split_model.py``; the bundles are the JAX tool's, byte for
byte, where PyYAML writes the topology file).

For each worker of the topology (or the one named by ``--worker``) the
tensors of its layers are copied, as stored, into
``<name>-node/model/{reduced.safetensors, model.safetensors.index.json}``;
the written file is read back as a check, the config and tokenizer are
copied beside it, and a single-worker ``topology.yml`` is written (YAML
with PyYAML, else JSON, which both packages' loaders read). Bytes are
copied, nothing is computed: the tool needs no device, and it splits bf16,
f32 and pre-quantized checkpoints alike.

Usage:
  python -m cake_tpu_torch.tools.split_model \\
      --model-path /path/to/llama --topology topology.yml --output ./bundles
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.utils.safetensors import SafetensorsFile, save_file
from cake_tpu_torch.utils.weights import load_safetensors_index


def reduce_for_worker(weight_map: dict[str, str], node) -> dict[str, str]:
    """The tensor name -> shard file entries of the worker's layers."""
    return {name: fname for name, fname in weight_map.items()
            if node.is_layer_owner(name)}


def split_for_worker(model_dir: Path, out_root: Path, topology: Topology,
                     node) -> Path:
    """Write ``node``'s bundle under ``out_root``; returns its model
    directory."""
    model_dir, out_root = Path(model_dir), Path(out_root)
    name_to_file = load_safetensors_index(model_dir)
    weight_map = {n: str(f.name) for n, f in name_to_file.items()}
    reduced = reduce_for_worker(weight_map, node)
    if not reduced:
        raise ValueError(f"worker '{node.name}' owns no tensors")

    out_dir = out_root / f"{node.name}-node" / "model"
    out_dir.mkdir(parents=True, exist_ok=True)

    files: dict[Path, SafetensorsFile] = {}
    tensors = {}
    for tname in sorted(reduced):
        f = name_to_file[tname]
        if f not in files:
            files[f] = SafetensorsFile(f)
        tensors[tname] = files[f].get_tensor(tname)

    out_file = out_dir / "reduced.safetensors"
    save_file(tensors, out_file)
    index = {
        "metadata": {"total_size": int(sum(
            t.numel() * t.element_size() for t in tensors.values()))},
        "weight_map": {n: "reduced.safetensors" for n in tensors},
    }
    (out_dir / "model.safetensors.index.json").write_text(json.dumps(index))

    # self-check: the written file holds exactly the tensors copied
    written = set(SafetensorsFile(out_file).keys())
    if written != set(tensors):
        raise RuntimeError(
            f"verification failed for '{node.name}': wrote {len(tensors)} "
            f"tensors, file has {len(written)}")

    for aux in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        src = model_dir / aux
        if src.exists():
            shutil.copy(src, out_dir / aux)

    single = Topology.from_dict({node.name: {
        "host": node.host, "description": node.description,
        "layers": list(node.layers),
    }})
    single.save(out_root / f"{node.name}-node" / "topology.yml")
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cake-split-model")
    p.add_argument("--model-path", required=True)
    p.add_argument("--topology", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--worker", default=None,
                   help="split only this worker (default: all)")
    args = p.parse_args(argv)

    model_dir = Path(args.model_path)
    topology = Topology.from_path(args.topology)
    out_root = Path(args.output)

    nodes = list(topology)
    if args.worker:
        if args.worker not in topology:
            sys.exit(f"error: worker '{args.worker}' not in topology")
        nodes = [topology[args.worker]]

    for node in nodes:
        out = split_for_worker(model_dir, out_root, topology, node)
        total = sum(f.stat().st_size
                    for f in out.glob("reduced.safetensors"))
        print(f"{node.name}: {out} ({total / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
