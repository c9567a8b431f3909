"""Checkpoint fetching: populate a model dir from a remote or local source
(a copy of ``cake_tpu/utils/fetch.py``; the port imports nothing of the
JAX package).

Fetching is an explicit, idempotent convenience (CLI ``--fetch``):

- ``hf://org/name[@revision]`` — snapshot the inference files from the HF Hub
  into the model dir (requires ``huggingface_hub``, imported only here, and
  network).
- ``file:///path`` or a plain directory path — copy from a local source
  (also the offline test plane).

Files already present in the destination are kept (pass ``force=True`` to
re-copy) — a fresh machine gets a one-command setup, a warm one stays warm.
A hub fetch stamps the directory (``.cake_fetched``) with what it fetched,
byte for byte as the JAX package does, so either package accepts a
checkout the other fetched.
"""

from __future__ import annotations

import fnmatch
import logging
import os
import shutil
from pathlib import Path

log = logging.getLogger("cake_tpu_torch.fetch")

# the inference file set: model config + tokenizer + weights (+ shard index)
DEFAULT_PATTERNS = (
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "*.safetensors",
    "model.safetensors.index.json",
)


def fetch_checkpoint(
    src: str,
    dest: str | Path,
    patterns: tuple[str, ...] = DEFAULT_PATTERNS,
    force: bool = False,
) -> Path:
    """Materialize checkpoint files from ``src`` into ``dest``; returns
    ``dest``. Idempotent: existing files are kept unless ``force``."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)

    if src.startswith("hf://"):
        return _fetch_hub(src[len("hf://"):], dest, patterns, force)

    srcdir = Path(src[len("file://"):] if src.startswith("file://") else src)
    if not srcdir.is_dir():
        raise FileNotFoundError(f"checkpoint source {srcdir} is not a directory")
    copied = 0
    for f in sorted(srcdir.iterdir()):
        if not f.is_file():
            continue
        if not any(fnmatch.fnmatch(f.name, p) for p in patterns):
            continue
        target = dest / f.name
        if target.exists() and not force:
            log.debug("fetch: %s already present, keeping", f.name)
            continue
        shutil.copy2(f, target)
        copied += 1
    log.info("fetched %d file(s) from %s into %s", copied, srcdir, dest)
    return dest


_STAMP = ".cake_fetched"


def _files_complete(dest: Path) -> bool:
    """config + every shard the safetensors index names (or at least one
    monolithic safetensors file)."""
    if not (dest / "config.json").exists():
        return False
    idx = dest / "model.safetensors.index.json"
    if idx.exists():
        import json

        try:
            shards = set(json.loads(idx.read_text())["weight_map"].values())
        except (ValueError, KeyError):
            return False
        return bool(shards) and all((dest / s).exists() for s in shards)
    return any(dest.glob("*.safetensors"))


def _hub_populated(dest: Path, want: str) -> bool:
    """Is this dir a COMPLETE checkout of ``want`` (``repo`` or
    ``repo@rev``)? Completeness cannot be judged from files alone (a repo
    may legitimately lack tokenizer.json; a download may have died between
    shards), so a successful snapshot writes a stamp recording what it
    fetched; stamp match + config + every index-named shard => skip the
    network."""
    stamp = dest / _STAMP
    return (stamp.exists() and stamp.read_text().strip() == want
            and _files_complete(dest))


# config.json fields that identify a model — architecture/size plus the
# content-bearing fields that differ between same-architecture repos
# (e.g. Llama-3 base vs Instruct differ in eos_token_id). A fingerprint,
# not byte verification: same-config same-architecture finetunes are
# indistinguishable, which the caller warns about.
_IDENTITY_KEYS = (
    "architectures", "hidden_size", "num_hidden_layers",
    "num_attention_heads", "num_key_value_heads", "vocab_size",
    "intermediate_size", "bos_token_id", "eos_token_id", "rope_theta",
    "rope_scaling", "torch_dtype", "max_position_embeddings",
)


def _legacy_identity_ok(repo: str, revision: str | None,
                        dest: Path) -> bool | None:
    """Best-effort identity check of an UNSTAMPED complete checkout against
    the hub repo's config.json (one small file, not the weights). Returns
    True (fingerprint matches), False (different model — the dir must not be
    served/stamped as ``repo``), or None (hub unreachable: cannot judge)."""
    import json
    import tempfile

    try:
        from huggingface_hub import hf_hub_download

        with tempfile.TemporaryDirectory() as td:
            p = hf_hub_download(repo_id=repo, revision=revision,
                                filename="config.json", local_dir=td)
            hub_cfg = json.loads(Path(p).read_text())
        local_cfg = json.loads((dest / "config.json").read_text())
    except Exception as e:
        log.warning(
            "fetch: cannot verify unstamped checkout %s against %s (%s)",
            dest, repo, e,
        )
        return None
    return ({k: hub_cfg.get(k) for k in _IDENTITY_KEYS}
            == {k: local_cfg.get(k) for k in _IDENTITY_KEYS})


def _fetch_hub(repo: str, dest: Path, patterns: tuple[str, ...],
               force: bool) -> Path:
    revision = None
    if "@" in repo:
        repo, revision = repo.split("@", 1)
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover - env without the hub client
        raise RuntimeError(
            "hf:// fetch requires the huggingface_hub package"
        ) from e
    want = f"{repo}@{revision}" if revision else repo
    # Only an unpinned fetch or an immutable commit-hash pin may skip the
    # hub on a stamp match; a branch/tag pin (movable) must always consult
    # the hub or it would track a stale tip forever.
    import re

    immutable = revision is None or bool(
        re.fullmatch(r"[0-9a-f]{7,40}", revision)
    )
    if not force and immutable and _hub_populated(dest, want):
        log.info("fetch: %s already populated (%s), skipping hub", dest, want)
        return dest
    # Pre-stamp-era checkout (no stamp, but config + tokenizer + weights all
    # present): verify it actually IS ``repo`` before stamping — an unstamped
    # complete checkout of a *different* model must not be silently served
    # and permanently mislabeled as the requested repo. The check costs one
    # small config.json download; if the hub is unreachable the checkout is
    # used for this run but left unstamped so the next online run verifies.
    # UNPINNED fetches only: the architecture fingerprint cannot tell
    # revisions of the same repo apart, so a commit-hash pin always goes to
    # the hub for the true pinned files.
    if (
        not force and revision is None and not (dest / _STAMP).exists()
        and (dest / "tokenizer.json").exists() and _files_complete(dest)
    ):
        verdict = _legacy_identity_ok(repo, revision, dest)
        if verdict is None:
            # Hub unreachable: identity cannot be judged. Default is
            # serve-with-a-warning (an offline pod must not be bricked by
            # a transient hub outage); CAKE_FETCH_STRICT=1 closes the
            # remaining serve-model-B-as-A window by refusing instead —
            # the posture for anything where mislabeling is worse than
            # unavailability.
            if os.environ.get("CAKE_FETCH_STRICT") == "1":
                raise RuntimeError(
                    f"{dest} is a complete but unstamped checkout and the "
                    f"hub is unreachable to verify it is {repo}; refusing "
                    "under CAKE_FETCH_STRICT=1 (unset it, or re-run online "
                    "once so the checkout can be verified and stamped)"
                )
            log.warning(
                "fetch: using unstamped checkout %s unverified (hub "
                "unreachable); not stamping (set CAKE_FETCH_STRICT=1 to "
                "refuse instead)", dest,
            )
            return dest
        if verdict:
            (dest / _STAMP).write_text(want)
            log.warning(
                "fetch: %s matches %s's config fingerprint and was stamped "
                "— this verifies architecture + tokenizer/rope config, not "
                "weight bytes; use --refetch if the dir might hold a "
                "same-config finetune", dest, want,
            )
            return dest
        raise RuntimeError(
            f"{dest} holds a complete checkpoint whose config.json does not "
            f"match {repo}; refusing to serve it as {want} (use --refetch "
            f"to overwrite it with the requested model)"
        )
    # About to mutate dest: a download dying halfway must not leave a
    # valid-looking stamp certifying a mixed checkout.
    (dest / _STAMP).unlink(missing_ok=True)
    snapshot_download(
        repo_id=repo,
        revision=revision,
        local_dir=str(dest),
        allow_patterns=list(patterns),
    )
    (dest / _STAMP).write_text(want)
    log.info("fetched %s from the HF Hub into %s", want, dest)
    return dest
