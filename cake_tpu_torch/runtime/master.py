"""Master: distributed generation across topology-assigned runners (port
of ``cake_tpu/runtime/master.py``).

The master holds the embedding, the final norm, the head, the tokenizer
and the sampler, and walks the decoder layers as the topology's segments
(planned once, ``Topology.segments``): a local segment runs on this
process's device (:class:`~cake_tpu_torch.parallel.runner.LocalRunner`),
a remote one is one wire round trip to its worker
(:class:`~cake_tpu_torch.parallel.runner.RemoteRunner`). The activation
stays a device tensor across local segments and becomes host bytes only
at a remote hop. Tokens/sec excludes the first token (the prefill).

Sampling is :class:`~cake_tpu_torch.runtime.generator.GeneratorBase`'s,
so a seeded stream draws the same noise as the local generator's. A guide
(constrained decoding) masks the sample on the master: workers only ever
see activations, so the wire is unchanged.
"""

from __future__ import annotations

import logging
import time

import torch

from cake_tpu_torch.models import llama
from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.obs import cluster as obs_cluster
from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.runner import BlockRunner, LocalRunner, RemoteRunner
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import protocol, wire
from cake_tpu_torch.runtime.generator import GeneratorBase, Token, _bucket

log = logging.getLogger("cake_tpu_torch.master")


def build_runners(
    config: LlamaConfig,
    topology: Topology,
    local_params_loader,  # callable (start, stop) -> stacked layers
    max_seq: int | None = None,
    wire_codec: str = "none",
    op_timeout_s: float | None = None,
    connect_retries: int = 0,
    recover_deadline_s: float | None = None,
) -> list[BlockRunner]:
    """Plan the block walk: one runner per contiguous same-owner segment.
    Unassigned layers run locally on the master. ``wire_codec`` selects
    every remote hop's activation encoding; the failure-domain knobs pass
    through to every RemoteRunner. A node whose ``host`` is a list hands
    its replica set to its runner (failover order)."""
    runners: list[BlockRunner] = []
    for seg in topology.segments(config.num_hidden_layers):
        if seg.owner is None:
            runners.append(LocalRunner(
                config, local_params_loader(seg.start, seg.stop),
                seg.start, seg.stop, max_seq=max_seq or config.max_seq_len))
        else:
            node = topology[seg.owner]
            runner = RemoteRunner(
                node.hosts or node.host, seg.start, seg.stop,
                max_seq=max_seq or config.max_seq_len,
                wire_codec=wire_codec,
                op_timeout_s=op_timeout_s,
                connect_retries=connect_retries,
                recover_deadline_s=recover_deadline_s)
            log.info("connected: %s", runner.info)
            runners.append(runner)
    return runners


class DistributedGenerator(GeneratorBase):
    """The generator surface over a runner plan: embed on the master's
    device, the runner walk, then the head and the shared sampler."""

    MAX_CONSEC_RECOVERIES = 3
    # the mask applies to the master's sample only; its [vocab] bool row
    # goes up to the device each token (the host's per-token walk over
    # the runners sets the rate here)
    supports_guide = True

    def __init__(
        self,
        config: LlamaConfig,
        head_params: dict,  # embed, norm_f, lm_head
        runners: list[BlockRunner],
        tokenizer=None,
        settings: SamplerSettings | None = None,
        max_seq: int | None = None,
        device=None,
    ):
        super().__init__(config, tokenizer, settings, max_seq, device)
        if head_params["embed"].device.type != self.device.type:
            raise ValueError(
                f"head params lie on {head_params['embed'].device}, the "
                f"master runs on {self.device}")
        self.runners = runners
        self._seg_idents = [r.ident() for r in runners]
        self.head = {k: head_params[k] for k in ("embed", "norm_f",
                                                 "lm_head")}
        self._t_start: float | None = None
        # per-segment forward times: the first call of each prompt
        # (prefill) in a warm-up gauge, steady-state decode in the
        # histogram; per-instance and published under stable names
        reg = obs_metrics.registry()
        self._seg_hist = [obs_metrics.Histogram(f"master.segment{i}.decode_ms")
                          for i in range(len(runners))]
        self._seg_warm = [obs_metrics.Gauge(f"master.segment{i}.warmup_ms")
                          for i in range(len(runners))]
        reg.publish(*self._seg_hist, *self._seg_warm)
        self._tokens_ctr = obs_metrics.counter("master.tokens_generated")
        self._recoveries_ctr = obs_metrics.counter("master.recoveries")
        self._failovers_ctr = obs_metrics.counter("master.failovers")
        self._last_seg_ms: list[float] = []
        self._last_sample_ms = 0.0
        self.recoveries = 0
        self.failovers = 0
        self._consec_recoveries = 0
        self._timing_paused = False  # replay forwards are not decode samples
        # model calls, for callers that check kernel launches
        self.prefill_calls = 0
        self.decode_steps = 0
        self._scraper = None

    def _on_new_prompt(self) -> None:
        self._t_start = None
        self._consec_recoveries = 0
        for g in self._seg_warm:
            g.set(0.0)
        # recover(), not reset(): a worker restarting between prompts gets
        # the same backoff budget and failover as a mid-stream fault
        self._recover_runners()

    def _recover_runners(self) -> None:
        for i, r in enumerate(self.runners):
            if r.recover():
                self.failovers += 1
                self._failovers_ctr.inc()
                self._seg_idents[i] = r.ident()

    # -- forward across runners --------------------------------------------
    def _forward(self, tokens: list[int], pos: int,
                 last_index: int) -> torch.Tensor:
        """f32 logits ``[vocab]`` at ``last_index`` of ``tokens`` fed at
        ``pos``. Local segments' times measure their launches (the card
        catches up at the next hop's host copy or the head's)."""
        x = llama.embed_tokens(
            self.head, torch.tensor([tokens], device=self.device),
            self.config)
        self._last_seg_ms = []
        for i, runner in enumerate(self.runners):
            runner.last_call = {}
            t0 = time.perf_counter()
            with span("decode.segment", seg=i, ident=self._seg_idents[i]):
                x = runner.forward(x, pos)
            dt = time.perf_counter() - t0
            self._last_seg_ms.append(dt * 1e3)
            seg_ms = dt * 1e3 - runner.last_call.get(
                "clock_refresh_ms", 0.0) - runner.last_call.get(
                "lock_wait_ms", 0.0)
            if self._timing_paused:
                pass  # recovery replay: prefill-sized, not steady-state
            elif self._seg_warm[i].value == 0.0:
                self._seg_warm[i].set(seg_ms)
            else:
                self._seg_hist[i].observe(seg_ms)
        return llama.lm_head(self.head, x[:, last_index], self.config)[0]

    def _replay_context(self) -> torch.Tensor:
        """Reconnect every segment (a fresh connection is fresh worker-side
        caches, possibly on another replica) and rebuild them by replaying
        prompt + generated-so-far in one pass; returns the logits at the
        last context position."""
        self._recover_runners()
        ctx = self._prompt_tokens + self._generated
        n = len(ctx)
        if n > self.max_seq:
            raise RuntimeError("cannot recover: context exceeds max_seq")
        t_pad = _bucket(n, self.max_seq)
        self._timing_paused = True
        try:
            with span("recover.replay", tokens=n):
                logits = self._forward(ctx + [0] * (t_pad - n), 0, n - 1)
        finally:
            self._timing_paused = False
        self._pos = n
        self.recoveries += 1
        self._recoveries_ctr.inc()
        return logits

    def _recover(self, e: Exception) -> torch.Tensor:
        """Reconnect+replay until logits land or the consecutive-recovery
        cap trips (the replay itself may fault). Transport failures only:
        a worker-reported op error is deterministic and propagates."""
        while True:
            self._consec_recoveries += 1
            if self._consec_recoveries > self.MAX_CONSEC_RECOVERIES:
                raise RuntimeError(
                    f"giving up after {self.MAX_CONSEC_RECOVERIES} "
                    "consecutive recovery attempts") from e
            log.warning("segment forward failed (%s); reconnecting and "
                        "replaying %d-token context", e,
                        len(self._prompt_tokens) + len(self._generated))
            try:
                return self._replay_context()
            except (OSError, wire.WireError) as e2:
                e = e2

    # -- Generator surface --------------------------------------------------
    @torch.inference_mode()
    def next_token(self, index: int) -> Token:
        t_tok0 = time.perf_counter()
        recoveries0 = self.recoveries
        failovers0 = self.failovers
        if index == 0:
            self._require_prompt()
            n = len(self._prompt_tokens)
            t_pad = _bucket(n, self.max_seq)
            with span("prefill", tokens=n):
                try:
                    logits = self._forward(
                        self._prompt_tokens + [0] * (t_pad - n), 0, n - 1)
                    self._pos = n
                    self.prefill_calls += 1
                except (OSError, wire.WireError) as e:
                    logits = self._recover(e)
                tok_id = self._sample_id(logits, index)
        else:
            self._check_capacity()
            with span("decode.step", index=index):
                try:
                    logits = self._forward([self._last_token], self._pos, 0)
                    self._pos += 1
                    self.decode_steps += 1
                    self._consec_recoveries = 0
                except (OSError, wire.WireError) as e:
                    logits = self._recover(e)
                tok_id = self._sample_id(logits, index)
        if index == 0:
            self._t_start = time.perf_counter()
        self._tokens_ctr.inc()
        rec = obs_flight.recorder()
        if rec.enabled:
            wire_tot = {"wire_bytes_out": 0, "wire_bytes_in": 0,
                        "wire_bytes_raw": 0,
                        "serialize_ms": 0.0, "deserialize_ms": 0.0}
            for r in self.runners:
                for k in wire_tot:
                    wire_tot[k] += r.last_call.get(k, 0)
            rec.record(
                index=index,
                kind="prefill" if index == 0 else "decode",
                total_ms=round((time.perf_counter() - t_tok0) * 1e3, 3),
                segments_ms=[round(ms, 3) for ms in self._last_seg_ms],
                sample_ms=round(self._last_sample_ms, 3),
                recovery=self.recoveries > recoveries0,
                failover=self.failovers > failovers0,
                **{k: round(v, 3) if isinstance(v, float) else v
                   for k, v in wire_tot.items()},
            )
        return self._finish_token(tok_id)

    def _sample_id(self, logits: torch.Tensor, index: int) -> int:
        """Sample + history push, timed for the flight record (the int()
        fetch synchronizes, so sample_ms covers the card's work)."""
        t0 = time.perf_counter()
        with span("sample", index=index):
            tok_id = int(self._sample(logits, index))
        self._last_sample_ms = (time.perf_counter() - t0) * 1e3
        return tok_id

    def tokens_per_sec(self) -> float | None:
        """Decode throughput excluding the first token; None until two
        tokens landed or while the clock has not measurably advanced."""
        if self._t_start is None or len(self._generated) < 2:
            return None
        dt = time.perf_counter() - self._t_start
        if dt < 1e-6:
            return None
        return (len(self._generated) - 1) / dt

    def runner_stats(self) -> list[dict]:
        """Per-segment steady-state decode latency from the histograms
        (the warm-up call apart), with each remote segment's handshake RTT
        and its ping-estimated link RTT and clock offset."""
        stats = []
        for i, r in enumerate(self.runners):
            h = self._seg_hist[i]
            entry = {
                "ident": r.ident(),
                "layers": f"{r.start}-{r.stop - 1}",
                "calls": h.count,
                "avg_ms": h.mean,
                "p50_ms": h.percentile(0.5),
                "p99_ms": h.percentile(0.99),
                "warmup_ms": self._seg_warm[i].value,
            }
            info = getattr(r, "info", None)
            if info is not None and getattr(info, "latency_ms", None):
                entry["handshake_ms"] = round(info.latency_ms, 2)
            addrs = getattr(r, "addrs", None)
            if addrs and len(addrs) > 1:
                entry["replicas"] = list(addrs)
            # the cluster report's rtt/offset fields, from one source
            entry.update({k: v for k, v in obs_cluster.runner_link(r).items()
                          if v is not None})
            stats.append(entry)
        return stats

    # -- cluster view --------------------------------------------------------
    def cluster_scraper(self, straggler_factor: float | None = None):
        """The :class:`~cake_tpu_torch.obs.cluster.ClusterScraper` over
        this plan's remote segments: a WireSource per CAP_STATS worker (in
        band, no status port needed); a worker without the capability that
        advertises a ``status_port`` in its handshake is scraped over HTTP
        at its connection host. Made once, so ``--top`` and
        ``--cluster-report`` aggregate into the same ``cluster.*``
        series."""
        if self._scraper is None:
            sources = []
            for r in self.runners:
                if not isinstance(r, RemoteRunner):
                    continue
                if protocol.CAP_STATS in r.caps:
                    sources.append(obs_cluster.WireSource(r))
                elif getattr(r.info, "status_port", 0):
                    host = r.addr.rsplit(":", 1)[0]
                    sources.append(obs_cluster.HttpSource(
                        f"http://{host}:{r.info.status_port}/",
                        name=r.info.name, runner=r))
            self._scraper = obs_cluster.ClusterScraper(
                sources,
                straggler_factor or obs_cluster.DEFAULT_STRAGGLER_FACTOR)
        return self._scraper

    def cluster_report(self, straggler_factor: float | None = None) -> dict:
        """One aggregation pass over every remote worker plus this
        master's own per-segment view (the ``--cluster-report`` file)."""
        report = self.cluster_scraper(straggler_factor).scrape()
        report["segments"] = self.runner_stats()
        report["tokens_per_sec"] = self.tokens_per_sec()
        report["recoveries"] = self.recoveries
        report["failovers"] = self.failovers
        return report

    def close(self) -> None:
        for r in self.runners:
            r.close()
