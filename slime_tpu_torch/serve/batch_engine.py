"""Continuous-batching decode engine: port of ``slime_tpu/serve/batch_engine.py``.

A fixed number of decode slots share one KV cache [L, slots, cache_len, KVH,
hd] (float or int8). Each request is prefilled on its own (multimodal fusion
included), whole or in ``prefill_chunk_len``-position chunks through
``llama.prefill_chunk``, its KV written into a free slot, and every engine
tick advances all active slots with one batched ``llama.decode_step`` (or
``multi_step`` of them when nothing waits for admission). Finished slots
(EOS / budget) retire at once and free capacity; ``cancel`` retires a
request from any thread at the next tick.

What the port keeps of the JAX engine is its outputs: the same admissions,
chunk sizes, decode windows, retirements and emitted tokens, the first token
host-sampled with numpy from ``numpy.random.default_rng(seed)`` draw for
draw, and in-graph draws from a ``torch.Generator`` seeded with ``seed``.
JAX's compile workarounds (device scalars, pow2 buckets for whole
admissions, donation, module-level jits) have no counterpart. Each dispatch
packs what the host reads into one int32 tensor (logprob floats through
``.view(torch.int32)``); overlapped decode copies it into pinned host memory
behind the dispatch and waits on that copy's event alone, so the host
reads dispatch N while N + 1 runs.

Constrained decoding (``register_grammar``, ``serve/grammar.py``): the
registered token DFAs live on the device as one combined table pair (state 0
passes everything), each slot keeps its automaton state there, and a decode
step masks the logits and advances the states itself; the tables are
uploaded once per registration, never per step, and a step with no
constrained slot skips the mask.

Speculative decoding (``draft_params``, ``serve/speculative.py``): in the
idle regime, when every active slot is greedy or plain temperature/top_p
without grammar, penalties or logprobs, a tick runs up to ``spec_rounds``
rounds: ``spec_k`` draft steps of every slot on a batched draft cache that
mirrors the slots, one verify chunk of ``max_slots * (spec_k + 1)`` rows
(``llama.prefill_chunk``, K1-K3 on the card), the per-slot accept rule
(longest matching prefix, or the rejection rule for sampled slots) and a
rollback that resets ``cache["length"]``. A slot that stops (EOS, budget,
cache room) is masked for the dispatch's later rounds, which still run: the
host bounds the rounds by the largest budget and reads every round in one
pull at the end, so no round waits for a sync.

Multi-LoRA (``register_adapter``): one base model serves many fine-tunes at
once. The registry holds each projection's adapters stacked [N, L, r, ...]
on the device (id 0 is the base: zeros); a slot's adapter applies as
``layers.linear``'s per-row ``lora_b`` entry, gathered to the slots from the
registry only when the slot->adapter map changes (``lora_view_builds``
counts the rebuilds), never per step. A tick with an adapter slot decodes
non-fused (the fused kernels K1-K3 cannot see the per-row deltas); when the
last adapter slot frees, decode returns to the fused path. A request's
admission prefill runs with its own adapter attached as single ``lora``
entries; an unknown ``adapter_id``, or an adapter with a shared prefix
(whose KV the base computed), fails the request, and adapted prompts never
enter the prefix cache.

Tensor-parallel serving (``mesh``, ``parallel/mesh.py``): the parameters
(and the draft's) are sharded by the rule table unless they already are
(stacked layers as their list, ``mesh.layer_list``), every KV pool holds
this rank's kv heads, the fused decode is off, and every step runs under the
mesh (``llama``'s per-layer views, one all-reduce a Megatron pair). JAX
decides once for every device; here each rank runs the whole engine, so its
host decisions must agree: rank 0 owns the requests. ``submit``, ``cancel``,
``register_grammar``, ``register_adapter`` and ``register_prefix`` on rank 0
become operations that the next ``tick`` broadcasts to every rank
(``broadcast_object_list``) and applies in one order before the tick's work;
admission, chunking, prefix-cache hits, speculative acceptance, grammar
states and the adapter map then follow on every rank from the same inputs
and the same (all-gathered) logits, with the same seeded generators. The
other ranks call ``follow()``, which ticks until rank 0's ``stop()``.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import IMAGE_TOKEN_INDEX, SliMEConfig
from ..generate import categorical, sample_token_dynamic
from ..models import llama, slime
from ..models.layers import fp32_accumulation, resolve_device
from ..parallel.mesh import layer_list, on_mesh, shard_params, use_mesh
from ..params import named_leaves
from .prefix_cache import PrefixCache, image_content_digest, image_slot_identities
from .speculative import rejection_round, warp_probs


class _Discard:
    """The out_queue of a request mirrored on a follower rank: rank 0
    streams the tokens; the copies are dropped."""

    def put(self, item) -> None:
        del item


_WIRE_SKIP = ("out_queue", "logprob_entries")


def _host(node):
    """A broadcast operation's argument with its tensors copied to the host
    (each rank puts them on its own card)."""
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host(v) for v in node)
    return node


@dataclass
class Request:
    input_ids: np.ndarray                       # [S]
    pixel_values: Optional[object] = None      # [MC, 3, t, t] numpy or tensor
    crop_mask: Optional[object] = None         # [MC]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0                     # nucleus sampling (ignored when greedy)
    top_k: int = 0                         # 0 = off (HF semantics, before top_p)
    min_p: float = 0.0                     # 0 = off (HF MinPLogitsWarper)
    repetition_penalty: float = 1.0        # HF/vLLM: over prompt + generated
    presence_penalty: float = 0.0          # OpenAI: over generated tokens
    frequency_penalty: float = 0.0         # OpenAI: over generated tokens
    prefix_id: Optional[str] = None        # shared prefix from register_prefix()
    grammar_id: Optional[int] = None       # constraint from register_grammar()
    adapter_id: Optional[int] = None       # LoRA from register_adapter(); 0 = base
    logprobs: int = 0                      # top-N alternatives per token (<=8)
    cancelled: bool = False                # set by engine.cancel() at retire time
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    out_queue: "queue.Queue" = field(default_factory=queue.Queue)
    # when logprobs > 0: one {"logprob", "top": [(id, lp), ...]} per emitted
    # token, appended before its token lands in out_queue
    logprob_entries: List[dict] = field(default_factory=list)

    def stream(self):
        """Yield generated token-id lists until completion."""
        while True:
            item = self.out_queue.get()
            if item is None:
                return
            yield item


class _Slot:
    __slots__ = ("req", "generated", "budget", "draft", "t_first")

    def __init__(self, req: Request):
        self.req = req
        self.generated: List[int] = []
        self.budget = req.max_new_tokens
        self.draft = None      # {"len": draft cache position} once speculating
        self.t_first = time.monotonic()   # first token just sampled (TTFT end)


def _insert(cache, k, v, slot: int, length: int):
    """k/v [L, S, KVH, hd] float admission KV -> positions [0, S) of the
    slot's rows, quantized on the way in for an int8 pool; the slot's length
    set. In place; returns the cache."""
    S = k.shape[1]
    if llama.cache_quantized(cache):
        (kq, ks), (vq, vs) = llama.quantize_kv(k), llama.quantize_kv(v)
        cache["k"][:, slot, :S] = kq
        cache["v"][:, slot, :S] = vq
        cache["k_scale"][:, slot, :S] = ks
        cache["v_scale"][:, slot, :S] = vs
    else:
        cache["k"][:, slot, :S] = k.to(cache["k"].dtype)
        cache["v"][:, slot, :S] = v.to(cache["v"].dtype)
    cache["length"][slot] = length
    return cache


def _seed_run(cache1, kblks, vblks, off: int):
    """Write a contiguous run of cached prefix blocks ([L, blk, KVH, hd]
    each) into the batch-1 admission cache at position ``off`` (JAX's
    ``_seed_block`` is the run of one)."""
    k = torch.cat(list(kblks), dim=1)
    v = torch.cat(list(vblks), dim=1)
    cache1["k"][:, 0, off:off + k.shape[1]] = k.to(cache1["k"].dtype)
    cache1["v"][:, 0, off:off + v.shape[1]] = v.to(cache1["v"].dtype)
    return cache1


def _slice_block(arr, off: int, *, blk: int):
    """[L, S, KVH, hd] -> a copy of positions [off, off + blk)."""
    return arr[:, off:off + blk].clone()


class BatchDecodeEngine:
    def __init__(self, params, cfg: SliMEConfig, *, max_slots: int = 8,
                 cache_len: int = 2048, compute_dtype=None, seed: int = 0,
                 draft_params=None, draft_cfg: Optional[SliMEConfig] = None,
                 spec_k: int = 4, spec_rounds: int = 8, mesh=None,
                 kv_quant: bool = False, prefix_cache_mb: int = 512,
                 prefix_block: int = 64, device=None):
        """``device``: where the engine runs, the current CUDA device when
        None (``layers.resolve_device``); every parameter must already be
        there. ``kv_quant``: the int8 KV pool (``llama.init_kv_cache``).
        ``prefix_cache_mb``: byte budget of the automatic prefix KV cache
        (``serve/prefix_cache.py``), 0 disables it; prompts sharing a
        ``prefix_block``-granular prefix with an earlier prompt (multimodal
        ones through their fused identity streams) skip recomputing it.
        ``draft_params`` / ``draft_cfg``: a text-only draft model of the same
        vocabulary for speculative rounds (``spec_k`` proposals a round, up
        to ``spec_rounds`` rounds a dispatch); it may be ``params`` itself.
        ``mesh``: tensor-parallel serving on every rank of the mesh (see
        the module docstring); ``device`` defaults to the mesh's."""
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params needs its draft_cfg")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device if device is None else device
            same = draft_params is params
            if not on_mesh(params, mesh):
                params = shard_params(mesh, layer_list(params))
            if same:
                draft_params = params
            elif draft_params is not None and not on_mesh(draft_params, mesh):
                draft_params = shard_params(mesh, layer_list(draft_params))
        # rank 0's pending operations, broadcast and applied by the next tick
        self._ops: list = []
        self._ops_lock = threading.Lock()
        self._following = False
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for what, tree in (("parameters", params), ("draft parameters", draft_params)):
            off = [n for n, t in named_leaves(tree or {}) if t.device != dev]
            if off:
                raise ValueError(f"BatchDecodeEngine on {dev}: {len(off)} {what} are "
                                 f"elsewhere (first: {off[0]})")
        self.device = dev
        self.params = params
        self.cfg = cfg
        self.compute_dtype = compute_dtype or torch.float32
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)  # first-token host sampling
        self.kv_quant = kv_quant
        with use_mesh(mesh):
            self.cache = llama.init_kv_cache(cfg.llm, max_slots, cache_len,
                                             dtype=self.compute_dtype, device=dev,
                                             quantized=kv_quant)
        self.cur_tokens = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._vocab_size = cfg.llm.vocab_size
        # constrained decoding: registered TokenDFAs, their offsets in the
        # combined tables, and each slot's automaton state on the device
        self.grammars = []
        self._g_offsets: List[int] = []
        self._rebuild_grammar_tables()
        self.gram_state = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        # penalty state: per-slot prompt presence (set at admission) and
        # generated-token counts (advanced in-graph); rows of penalty-free
        # slots are never read, so they go stale for free
        self.prompt_mask = torch.zeros((max_slots, self._vocab_size), dtype=torch.bool,
                                       device=dev)
        self.gen_counts = torch.zeros((max_slots, self._vocab_size), dtype=torch.int32,
                                      device=dev)
        # host mirror of cache["length"] per slot: picks the decode window
        # without a device pull (refreshed from every packed result)
        self._host_len = np.zeros((max_slots,), np.int64)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self.prefixes = {}             # prefix_id -> {"k","v","length"} shared KV
        self.prefix_cache = None
        if prefix_cache_mb > 0:
            self.prefix_cache = PrefixCache(block=prefix_block,
                                            budget_bytes=prefix_cache_mb << 20)
        self.prefill_chunk_len = 256   # admission granularity (bounds tick latency)
        self.multi_step = 8            # decode steps per dispatch when queue is idle
        # overlapped decode: one dispatch kept in flight in the idle regime;
        # (host handle, k, active ids, slot snapshot, n_lp) or None
        self._inflight = None
        self._admission = None         # in-flight chunked admission state
        self._cancel_ids: set = set()
        self._cancel_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._metrics = deque(maxlen=512)   # (ttft_s, n_tokens, decode_s)
        self._t_start = time.monotonic()
        # work counters: decode steps dispatched, chunks run by padded length
        self.decode_steps = 0
        self.chunk_rows: Counter = Counter()
        # speculation: the draft, its batched cache mirroring the slots, and
        # counters (rounds dispatched; slot-rounds read and proposals they
        # accepted; draft prefills)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.spec_rounds = max(1, spec_rounds)
        self.spec_stats = Counter()
        if draft_params is not None:
            with use_mesh(mesh):
                self.d_cache = llama.init_kv_cache(draft_cfg.llm, max_slots, cache_len,
                                                   dtype=self.compute_dtype, device=dev)
        # multi-LoRA: the stacked [N, L, ...] registry per projection, each
        # slot's adapter id, the decode view with gathered "lora_b" entries
        # (rebuilt only when the slot->adapter map changes) and the prefill
        # views per adapter id
        self.lora_stacks = None
        self._lora_rank = None
        self._n_adapters = 1                  # id 0 = the base model
        self._slot_adapter = np.zeros((max_slots,), np.int64)
        self._params_lora = None
        self._params_single = {}
        self._use_lora = False
        self.lora_view_builds = 0

    # ------------------------------------------------------------------
    # step functions (JAX's jitted closures)
    def _prefill(self, embeds, length: int, params=None):
        """Whole prompt embeds [1, S, H] -> (fp32 logits [V] at position
        length - 1, k, v [L, S, KVH, hd]); ``params`` defaults to the base."""
        params = self.params if params is None else params
        logits, kvs = llama.forward(
            params["llm"], embeds, self.cfg.llm, return_kv=True,
            compute_dtype=self.compute_dtype,
            logit_positions=torch.full((1,), length - 1, device=self.device))
        k = torch.stack([kv[0][0] for kv in kvs])
        v = torch.stack([kv[1][0] for kv in kvs])
        return logits[0, 0], k, v

    def _prefill_chunk(self, cache1, chunk, params=None):
        params = self.params if params is None else params
        return llama.prefill_chunk(params["llm"], cache1, chunk, self.cfg.llm,
                                   compute_dtype=self.compute_dtype)

    def _sample(self, logits, meta, use_filters: bool):
        # meta rows: [temps, active, top_p, top_k, min_p, rep, pres, freq]
        B = self.max_slots
        temperature = meta[:B]
        if use_filters:
            return sample_token_dynamic(logits, temperature, meta[2 * B:3 * B],
                                        top_k=meta[3 * B:4 * B],
                                        min_p=meta[4 * B:5 * B],
                                        generator=self.generator)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        t = torch.clamp(temperature, min=1e-6)[:, None]
        sampled = categorical(logits / t, self.generator)
        return torch.where(temperature > 0, sampled, greedy)

    def _penalize(self, logits, meta):
        # repetition penalty (vLLM/HF: prompt + generated), then OpenAI
        # presence/frequency (generated only); identity knobs are a no-op
        B = self.max_slots
        rep = meta[5 * B:6 * B][:, None]
        pres = meta[6 * B:7 * B][:, None]
        freq = meta[7 * B:8 * B][:, None]
        gcnt = self.gen_counts
        present = self.prompt_mask | (gcnt > 0)
        adj = torch.where(logits > 0, logits / rep, logits * rep)
        logits = torch.where(present, adj, logits)
        return logits - pres * (gcnt > 0) - freq * gcnt.to(logits.dtype)

    @staticmethod
    def _logprob_extra(logits, nxt, n_lp: int):
        # top-N alternatives and the sampled token's logprob on the
        # distribution the sampler saw (post penalties, pre temperature);
        # floats ride the int32 packed pull through a bit view
        lp = torch.log_softmax(logits, dim=-1)
        top_v, top_i = torch.topk(lp, n_lp, dim=-1)
        samp = torch.gather(lp, -1, nxt[:, None].long())[:, 0]
        bits = lambda a: a.to(torch.float32).contiguous().view(torch.int32)  # noqa: E731
        return [top_i.reshape(-1).to(torch.int32), bits(top_v).reshape(-1), bits(samp)]

    def _decode(self, tokens, meta, active, window, use_filters, use_penalties, n_lp,
                use_grammar=False):
        """One decode step of every slot -> (next tokens [B], logprob extras).
        ``use_grammar``: mask each row to its automaton state's allowed
        tokens before the penalties and the sampler, then advance the states
        of the active rows."""
        # an adapter slot decodes non-fused: K1-K3 cannot see lora_b deltas
        params = self._params_lora if self._use_lora else self.params
        logits, self.cache = llama.decode_step(
            params["llm"], self.cache, tokens, self.cfg.llm,
            compute_dtype=self.compute_dtype, window=window,
            fused=False if self._use_lora else None)
        if use_grammar:
            gs = self.gram_state.long()
            logits = logits.masked_fill(~self._g_allowed[gs], float("-inf"))
        if use_penalties:
            logits = self._penalize(logits, meta)
        nxt = self._sample(logits, meta, use_filters)
        if use_grammar:
            self.gram_state = torch.where(active, self._g_nxt[gs, nxt.long()],
                                          self.gram_state)
        if use_penalties:
            self.gen_counts.scatter_add_(1, nxt[:, None].long(),
                                         active.to(torch.int32)[:, None])
        extra = self._logprob_extra(logits, nxt, n_lp) if n_lp else []
        return nxt, extra

    def _pin_free_rows(self, active):
        """Free slots restart at position 0: their writes stay inside their
        own rows (JAX drops an out-of-range write; here it is an error)."""
        self.cache["length"] = torch.where(active, self.cache["length"], 0)
        return self.cache["length"]

    def _step_k(self, meta, k: int, window, use_filters, use_penalties, n_lp,
                use_grammar=False):
        """k decode steps in one dispatch (JAX's ``_step`` is k = 1, its
        ``_step_k`` k > 1) -> packed int32 [tokens (B, k), lengths (B)] and,
        with logprobs, [ids (B, k, n_lp), values (B, k, n_lp), sampled (B,
        k)]. Rows that hit EOS keep sampling (the host discards post-EOS
        tokens)."""
        B = self.max_slots
        active = meta[B:2 * B] > 0.5
        old_len = self._pin_free_rows(active)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                           device=self.device)
        out = zeros(B, k)
        lps = [zeros(B, k, n_lp), zeros(B, k, n_lp), zeros(B, k)] if n_lp else []
        tok = self.cur_tokens
        for i in range(k):
            tok, ex = self._decode(tok, meta, active, window, use_filters, use_penalties,
                                   n_lp, use_grammar)
            out[:, i] = tok
            for a, e in zip(lps, ex):
                a[:, i] = e.reshape(a[:, i].shape)
        self.cache["length"] = torch.where(active, self.cache["length"], old_len)
        self.cur_tokens = tok
        return torch.cat([out.reshape(-1), self.cache["length"]]
                         + [a.reshape(-1) for a in lps])

    def _pull(self, packed):
        """Start the device-to-host copy of a packed result -> (host tensor,
        event or None): pinned memory, non-blocking, with an event recorded
        behind it, so waiting for this dispatch never waits for a later one."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _upload(self, meta: np.ndarray):
        t = torch.from_numpy(meta)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    # speculation (JAX's _one_round / _spec_rounds closures)
    def _draft_prefill(self, ids: np.ndarray):
        """Draft KV [L, S, KVH, hd] of a token context (no logits kept)."""
        dl = self.draft_cfg.llm
        t = torch.from_numpy(ids.astype(np.int64)).to(self.device)[None]
        embeds = llama.embed(self.draft_params["llm"], t).to(self.compute_dtype)
        _, kvs = llama.forward(self.draft_params["llm"], embeds, dl, return_kv=True,
                               compute_dtype=self.compute_dtype,
                               logit_positions=torch.full((1,), t.shape[1] - 1,
                                                          device=self.device))
        return torch.stack([kv[0][0] for kv in kvs]), torch.stack([kv[1][0] for kv in kvs])

    def _d_insert(self, k, v, slot: int, length: int) -> None:
        self.d_cache = _insert(self.d_cache, k, v, slot, length)

    def _draft_steps(self, cur, d_len, alive, window, temps=None, tps=None,
                     use_sampling=False):
        """K draft steps of every slot from its token ``cur`` at its draft
        position ``d_len`` (0 for rows not alive) -> (proposals [B, K],
        their warped draft probs [B, K, V] when sampling, else None)."""
        K, dl, dp = self.spec_k, self.draft_cfg.llm, self.draft_params["llm"]
        self.d_cache["length"] = torch.where(alive, d_len, 0).to(torch.int32)
        props, qrows = [], []
        tok = cur
        for _ in range(K):
            lg, self.d_cache = llama.decode_step(dp, self.d_cache, tok, dl,
                                                 compute_dtype=self.compute_dtype,
                                                 window=window)
            if use_sampling:
                q = warp_probs(lg, temps, tps)
                tok = categorical(torch.log(q + 1e-30), self.generator)
                qrows.append(q)
            else:
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
            props.append(tok)
        return torch.stack(props, dim=1), (torch.stack(qrows, dim=1) if qrows else None)

    def _verify(self, cur, props, window):
        """The verify chunk: every slot's [cur, proposals] as one (K + 1)-wide
        ``prefill_chunk`` of B * (K + 1) rows -> logits [B, K + 1, V]; the
        cache lengths advance by K + 1 (the caller rolls them back)."""
        tp = self.params["llm"]
        embeds = llama.embed(tp, torch.cat([cur[:, None], props], dim=1)).to(self.compute_dtype)
        logits, self.cache = llama.prefill_chunk(tp, self.cache, embeds, self.cfg.llm,
                                                 compute_dtype=self.compute_dtype,
                                                 window=window)
        return logits

    def _ingest(self, tokens, window) -> None:
        """One draft step that only writes the KV of ``tokens`` [B]."""
        _, self.d_cache = llama.decode_step(self.draft_params["llm"], self.d_cache, tokens,
                                            self.draft_cfg.llm,
                                            compute_dtype=self.compute_dtype, window=window)

    def _one_round(self, cur, d_len, alive, window, temps=None, tps=None,
                   use_sampling=False):
        """One batched draft-K / verify / rollback round over every slot ->
        (cur', d_len', targets [B, K+1], acc [B]). Per live slot,
        targets[b, :acc[b] + 1] are the target's greedy tokens (or, with
        ``use_sampling``, the accepted proposals and the rejection-resampled
        or bonus token). Rows not alive compute at position 0 of their own
        cache rows (their slot retires after the dispatch) and keep their
        lengths and tokens."""
        K = self.spec_k
        old_len = self.cache["length"]
        props, qrows = self._draft_steps(cur, d_len, alive, window, temps, tps, use_sampling)
        self.cache["length"] = torch.where(alive, old_len, 0)
        logits = self._verify(cur, props, window)
        if use_sampling:
            targets, acc = rejection_round(self.generator, props, qrows,
                                           warp_probs(logits, temps, tps))
        else:
            targets = torch.argmax(logits, dim=-1).to(torch.int32)
            miss = props != targets[:, :K]
            acc = torch.where(miss.any(dim=1), miss.to(torch.int32).argmax(dim=1),
                              K).to(torch.int32)
        n_emit = torch.where(alive, acc + 1, 0).to(torch.int32)
        # rollback: the verified prefix per slot; rows not alive keep theirs
        self.cache["length"] = (old_len + n_emit).to(torch.int32)
        # the draft ingests props[:, K-1], so a fully accepted round leaves a
        # complete draft cache; the next round's d_len rolls it back
        self._ingest(props[:, K - 1], window)
        rows = torch.arange(cur.shape[0], device=cur.device)
        new_cur = torch.where(alive, targets[rows, acc.long()], cur)
        return new_cur, d_len + n_emit, targets, acc

    def _spec_rounds(self, meta, rounds: int, window, sknobs=None, use_sampling=False):
        """``rounds`` batched rounds (``spec_rounds`` at most) in one
        dispatch. ``meta`` int32 [3B] = [d_len, budget, spec mask]. Returns
        packed int32 [lengths (B), accs (R, B), toks (R, B, K+1)]: for slot
        b and round r with accs[r, b] >= 0, toks[r, b, :accs[r, b] + 1] are
        the round's tokens; a slot stops on EOS, its budget or the cache
        room, and its later rounds read -1."""
        B, K, R = self.max_slots, self.spec_k, self.spec_rounds
        eos = self.cfg.eos_token_id
        cap = self.cache_len - K - 2
        d_len, budget, alive = meta[:B], meta[B:2 * B], meta[2 * B:] > 0
        temps = sknobs[:B] if use_sampling else None
        tps = sknobs[B:] if use_sampling else None
        emitted = torch.zeros((B,), dtype=torch.int32, device=self.device)
        accs = torch.full((R, B), -1, dtype=torch.int32, device=self.device)
        toks = torch.zeros((R, B, K + 1), dtype=torch.int32, device=self.device)
        pos = torch.arange(K + 1, device=self.device)[None]
        cur = self.cur_tokens
        for r in range(rounds):
            cur, d_len, targets, acc = self._one_round(cur, d_len, alive, window, temps,
                                                       tps, use_sampling)
            accs[r] = torch.where(alive, acc, -1)
            toks[r] = targets
            has_eos = ((pos <= acc[:, None]) & (targets == eos)).any(dim=1)
            emitted = emitted + torch.where(alive, acc + 1, 0)
            alive = alive & ~has_eos & (emitted < budget) & (self.cache["length"] < cap)
        self.cur_tokens = cur
        return torch.cat([self.cache["length"], accs.reshape(-1), toks.reshape(-1)])

    # ------------------------------------------------------------------
    # rank 0's operations under a mesh
    def _leader(self) -> bool:
        return self.mesh is not None and not self._following

    def _defer(self, op) -> None:
        with self._ops_lock:
            self._ops.append(op)

    def _exchange_ops(self) -> None:
        """Broadcast rank 0's pending operations and apply them, in order,
        on every rank (rank 0 applies its own objects)."""
        if not self._following:
            with self._ops_lock:
                ops, self._ops = self._ops, []
            wire = [[self._to_wire(op) for op in ops]]
        else:
            ops, wire = None, [None]
        if self.mesh.size > 1:
            dist.broadcast_object_list(wire, src=0, group=self.mesh.group("world"))
        for op in (ops if ops is not None else [self._from_wire(o) for o in wire[0]]):
            self._apply_op(op)

    @staticmethod
    def _to_wire(op):
        kind, arg = op
        if kind == "submit":
            arg = {k: getattr(arg, k) for k in arg.__dataclass_fields__ if k not in _WIRE_SKIP}
        return kind, _host(arg)

    @staticmethod
    def _from_wire(op):
        kind, arg = op
        if kind == "submit":
            return kind, Request(**arg, out_queue=_Discard())
        return op

    def _apply_op(self, op) -> None:
        kind, arg = op
        if kind == "submit":
            self.pending.put(arg)
        elif kind == "cancel":
            with self._cancel_lock:
                self._cancel_ids.add(arg)
        elif kind == "grammar":
            if self._following:               # rank 0 registered it at once
                self._register_grammar(arg)
        elif kind == "adapter":
            if self._following:
                self._register_adapter(arg)
        elif kind == "prefix":
            self._register_prefix(*arg)
        elif kind == "stop":
            self._stop.set()

    def follow(self) -> None:
        """A rank other than 0: tick with rank 0 until its ``stop()``."""
        self._following = True
        while not self._stop.is_set():
            self.tick()

    def register_grammar(self, token_dfa) -> int:
        """Register a compiled grammar (``serve/grammar.TokenDFA`` over this
        model's vocabulary) for requests' ``grammar_id``. The combined
        device tables are rebuilt and uploaded here, once per registration.
        Registration only appends, so existing grammars keep their state
        offsets while the engine thread runs. Under a mesh the other ranks
        register it at the next tick."""
        gid = self._register_grammar(token_dfa)
        if self._leader():
            self._defer(("grammar", token_dfa))
        return gid

    def _register_grammar(self, token_dfa) -> int:
        if token_dfa.allowed.shape[1] != self._vocab_size:
            raise ValueError(f"grammar over {token_dfa.allowed.shape[1]} tokens, the model "
                             f"has {self._vocab_size}")
        self.grammars.append(token_dfa)
        self._rebuild_grammar_tables()
        return len(self.grammars) - 1

    def _rebuild_grammar_tables(self) -> None:
        """The combined tables: state 0 passes everything; a state that
        allows nothing forces EOS (the slot ends instead of wedging); EOS
        leads back to state 0."""
        V = self._vocab_size
        eos = self.cfg.eos_token_id
        rows_a = [np.ones((1, V), bool)]
        rows_n = [np.zeros((1, V), np.int32)]
        offsets = []
        off = 1
        for td in self.grammars:
            a = td.allowed.copy()
            stuck = ~a.any(axis=1)
            if stuck.any() and 0 <= eos < V:
                a[stuck, eos] = True
            x = (td.nxt + off).astype(np.int32)
            if 0 <= eos < V:
                x[:, eos] = 0
            offsets.append(off)
            rows_a.append(a)
            rows_n.append(x)
            off += a.shape[0]
        self._g_allowed_h = np.concatenate(rows_a)
        self._g_nxt_h = np.concatenate(rows_n)
        self._g_allowed = torch.from_numpy(self._g_allowed_h).to(self.device)
        self._g_nxt = torch.from_numpy(self._g_nxt_h).to(self.device)
        self._g_offsets = offsets

    def register_adapter(self, lora_state: dict) -> int:
        """Register a LoRA adapter for per-request serving -> its adapter_id
        (under a mesh the other ranks register it at the next tick).

        ``lora_state`` is ``train.lora``'s layout over this engine's LLM
        layers, stacked ({"rank", "alpha", "adapters": {path: {"A" [L, r,
        in], "B" [L, out, r]}}}, ``lora.stack_adapter_state``); entries off
        the LLM layers are ignored. Adapters of different ranks zero-pad to
        the largest; a projection one adapter leaves out is zeros for it."""
        aid = self._register_adapter(lora_state)
        if self._leader():
            self._defer(("adapter", lora_state))
        return aid

    def _register_adapter(self, lora_state: dict) -> int:
        scale = lora_state["alpha"] / lora_state["rank"]
        f32 = dict(dtype=torch.float32, device=self.device)
        new = {}
        for path, ab in lora_state["adapters"].items():
            parts = path.split("/")
            if "layers" not in parts:
                continue                       # not an LLM-layer target
            A = torch.as_tensor(ab["A"]).detach().to(**f32)
            B = torch.as_tensor(ab["B"]).detach().to(**f32) * scale
            if A.dim() != 3 or B.dim() != 3:
                raise ValueError("register_adapter needs stacked [L, ...] adapters "
                                 "(lora.stack_adapter_state)")
            new[parts[-1]] = {"A": A, "B": B}
        if not new:
            raise ValueError("no LLM-layer adapters in lora_state")
        rank = max(self._lora_rank or 0, max(v["A"].shape[1] for v in new.values()))
        old_n = self._n_adapters
        stacks = {}
        for proj in set(new) | set(self.lora_stacks or {}):
            if self.lora_stacks is not None and proj in self.lora_stacks:
                oa, ob = self.lora_stacks[proj]["A"], self.lora_stacks[proj]["B"]
            else:                              # newly targeted: zeros before
                L_, _, in_d = new[proj]["A"].shape
                oa = torch.zeros((old_n, L_, 0, in_d), **f32)
                ob = torch.zeros((old_n, L_, new[proj]["B"].shape[1], 0), **f32)
            oa = torch.nn.functional.pad(oa, (0, 0, 0, rank - oa.shape[2]))
            ob = torch.nn.functional.pad(ob, (0, rank - ob.shape[3]))
            if proj in new:
                na, nb = new[proj]["A"], new[proj]["B"]
            else:
                na, nb = torch.zeros_like(oa[0]), torch.zeros_like(ob[0])
            na = torch.nn.functional.pad(na, (0, 0, 0, rank - na.shape[1]))
            nb = torch.nn.functional.pad(nb, (0, rank - nb.shape[2]))
            stacks[proj] = {"A": torch.cat([oa, na[None]]), "B": torch.cat([ob, nb[None]])}
        self.lora_stacks = stacks
        self._lora_rank = rank
        self._n_adapters = old_n + 1
        self._params_single.clear()
        self._refresh_lora_view(force=True)
        return self._n_adapters - 1

    def _with_layer_entries(self, entries):
        """The params tree with ``entries(proj) -> {key: factors}`` merged
        into each adapted projection of the LLM layers (list or stacked; a
        list takes layer li's slice of leading-[L] factors)."""
        base = self.params["llm"]["layers"]
        if isinstance(base, dict):
            layers = dict(base)
            for proj in self.lora_stacks:
                layers[proj] = {**layers[proj], **entries(proj)}
        else:
            layers = []
            for li, lp in enumerate(base):
                lp = dict(lp)
                for proj in self.lora_stacks:
                    lp[proj] = {**lp[proj], **{
                        k: {n: t[li] for n, t in ab.items()}
                        for k, ab in entries(proj).items()}}
                layers.append(lp)
        return {**self.params, "llm": {**self.params["llm"], "layers": layers}}

    def _refresh_lora_view(self, force: bool = False) -> None:
        """Rebuild the decode view with each slot's adapter gathered into
        ``lora_b`` entries ([L, B, r, in] / [L, B, out, r]). Called when the
        slot->adapter map changes."""
        if self.lora_stacks is None:
            return
        self._use_lora = bool(self._slot_adapter.any())
        if not self._use_lora and not force:
            return
        idx = torch.from_numpy(self._slot_adapter).to(self.device)
        gathered = {proj: {n: t.index_select(0, idx).transpose(0, 1) for n, t in ab.items()}
                    for proj, ab in self.lora_stacks.items()}
        self._params_lora = self._with_layer_entries(lambda proj: {"lora_b": gathered[proj]})
        self.lora_view_builds += 1

    def _prefill_params(self, req: Request):
        """The params for this request's admission prefill: the base tree,
        or the tree with the request's adapter attached as single ``lora``
        entries (cached per adapter id)."""
        aid = req.adapter_id or 0
        if not aid:
            return self.params
        if aid not in self._params_single:
            self._params_single[aid] = self._with_layer_entries(lambda proj: {"lora": {
                n: t[aid] for n, t in self.lora_stacks[proj].items()}})
        return self._params_single[aid]

    def _assign_adapter(self, slot_idx: int, req: Request) -> None:
        aid = req.adapter_id or 0
        if self._slot_adapter[slot_idx] != aid:
            self._slot_adapter[slot_idx] = aid
            self._refresh_lora_view()

    def register_prefix(self, input_ids, pixel_values=None, crop_mask=None,
                        prefix_id: Optional[str] = None) -> str:
        """Prefill a shared prefix (a system prompt, optionally with an image)
        once; later requests with ``prefix_id`` seed their admission cache
        with its KV and prefill only their suffix. Under a mesh every rank
        prefills it at the next tick (requests submitted after this call
        see it)."""
        pid = prefix_id or uuid.uuid4().hex[:8]
        if self._leader():
            self._defer(("prefix", (np.asarray(input_ids), pixel_values, crop_mask, pid)))
            return pid
        return self._register_prefix(input_ids, pixel_values, crop_mask, pid)

    def _register_prefix(self, input_ids, pixel_values, crop_mask, pid: str) -> str:
        req = Request(input_ids=np.asarray(input_ids), pixel_values=pixel_values,
                      crop_mask=crop_mask)
        with torch.no_grad(), fp32_accumulation():
            embeds, length, _ = self._embed_request(req)
            _, k, v = self._prefill(embeds, length)
        self.prefixes[pid] = {"k": k[:, :length], "v": v[:, :length],
                              "length": length, "ids": np.asarray(input_ids),
                              "text_only": pixel_values is None}
        return pid

    def submit(self, req: Request) -> Request:
        req._t_submit = time.monotonic()
        if self._leader():
            self._defer(("submit", req))
        else:
            self.pending.put(req)
        return req

    def cancel(self, request_id: str) -> None:
        """Abort a request from any thread; takes effect at the next tick: it
        leaves the pending queue, its chunked admission is dropped, or its
        decode slot retires."""
        if self._leader():
            self._defer(("cancel", request_id))
            return
        with self._cancel_lock:
            self._cancel_ids.add(request_id)

    def _apply_cancellations(self) -> None:
        if not self._cancel_ids:
            return
        with self._cancel_lock:
            ids, self._cancel_ids = self._cancel_ids, set()
        kept = []
        while True:
            try:
                r = self.pending.get_nowait()
            except queue.Empty:
                break
            if r.request_id in ids:
                r.cancelled = True
                r.out_queue.put(None)
            else:
                kept.append(r)
        for r in kept:
            self.pending.put(r)
        a = self._admission
        if a is not None and a["req"].request_id in ids:
            a["req"].cancelled = True
            a["req"].out_queue.put(None)
            self._admission = None
        for i, s in enumerate(self.slots):
            if s is not None and s.req.request_id in ids:
                s.req.cancelled = True
                self._retire(i)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _embed_request(self, req: Request):
        """-> (embeds [1, S, H], length, ident). Multimodal fusion runs here,
        at ``max_len`` = the cache room left after the request's budget.

        Multimodal suffixes of a text-only shared prefix fuse with the full
        text (prefix ids + suffix ids) and then drop the prefix positions:
        the text-guided selection conditions on the whole prompt. ``ident``
        is the fused identity stream of a plain multimodal request (the
        prefix cache's key), None otherwise."""
        dev = self.device
        ids = np.asarray(req.input_ids)[None]
        if req.pixel_values is not None:
            base = 0
            pre = self.prefixes.get(req.prefix_id) if req.prefix_id else None
            if pre is not None and pre["text_only"]:
                base = pre["length"]
                ids = np.concatenate([pre["ids"][None], ids], axis=1)
            max_len = base + self.cache_len - req.max_new_tokens - 1
            ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
            fused, img_valid = slime.prepare_multimodal(
                self.params, self.cfg, ids_t, torch.ones_like(ids_t, dtype=torch.bool),
                torch.as_tensor(req.pixel_values).to(dev)[None],
                torch.as_tensor(req.crop_mask).to(dev)[None],
                compute_dtype=self.compute_dtype, max_len=max_len, return_img_valid=True)
            length = int(fused.lengths[0])
            ident = None
            if req.prefix_id is None:
                ident = self._fused_identity(ids[0], img_valid[0].cpu().numpy(),
                                             req)[:length]
            return fused.embeds[:, base:], length - base, ident
        embeds = llama.embed(self.params["llm"], torch.from_numpy(
            ids.astype(np.int64)).to(dev)).to(self.compute_dtype)
        return embeds, ids.shape[1], None

    @staticmethod
    def _fused_identity(ids: np.ndarray, img_valid: np.ndarray,
                        req: Request) -> np.ndarray:
        """Host reconstruction of the fused sequence's identity stream, in
        ``slime.splice``'s layout: text[:img_pos] ++ image slots ++
        text[img_pos:], the sentinel and unselected slots dropped; token ids
        for text positions, ``image_slot_identities`` of the pixels' content
        digest for image-feature slots."""
        is_img = ids == IMAGE_TOKEN_INDEX
        img_pos = int(np.argmax(is_img)) if is_img.any() else len(ids)
        text_ident = np.where(is_img, 0, ids).astype(np.uint64)
        text_valid = ~is_img
        px, cm = req.pixel_values, req.crop_mask
        px = px.cpu().numpy() if isinstance(px, torch.Tensor) else np.asarray(px)
        cm = cm.cpu().numpy() if isinstance(cm, torch.Tensor) else np.asarray(cm)
        img_ident = image_slot_identities(image_content_digest(px, cm), img_valid.shape[0])
        ext_ident = np.concatenate([text_ident[:img_pos], img_ident, text_ident[img_pos:]])
        ext_valid = np.concatenate([text_valid[:img_pos], img_valid, text_valid[img_pos:]])
        return ext_ident[ext_valid]

    def _admission_step(self) -> bool:
        """Advance the in-flight chunked admission by one chunk; True when one
        is in flight (the caller pulls no new work beyond decode)."""
        if self._admission is None:
            if self.pending.empty() or self._free_slot() is None:
                return False
            req = self.pending.get()
            if req.prefix_id is not None and req.prefix_id not in self.prefixes:
                req.out_queue.put(None)    # fail this request, not the engine thread
                return False
            if req.grammar_id is not None and not 0 <= req.grammar_id < len(self.grammars):
                req.out_queue.put(None)    # an unknown grammar fails the request
                return False
            if req.adapter_id and (not 0 < req.adapter_id < self._n_adapters
                                   or req.prefix_id is not None):
                # an unknown adapter, or a shared prefix (its KV computed with
                # the base weights) under an adapter that would change it
                req.out_queue.put(None)
                return False
            embeds, length, ident = self._embed_request(req)
            pre = self.prefixes.get(req.prefix_id) if req.prefix_id else None
            if (pre["length"] if pre else 0) + length >= self.cache_len:
                # no room to decode: the pool cannot hold the prompt
                req.out_queue.put(None)
                return False
            cache_key = ident if req.pixel_values is not None else np.asarray(req.input_ids)
            C = self.prefill_chunk_len
            base = 0
            auto_hit = []
            if (req.prefix_id is None and cache_key is not None
                    and not req.adapter_id        # adapters change prefix KV
                    and self.prefix_cache is not None):
                base, auto_hit = self.prefix_cache.match(cache_key)
            if req.prefix_id is not None:
                pre = self.prefixes[req.prefix_id]
                base = pre["length"]
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype, device=self.device)
                cache1 = _insert(cache1, pre["k"], pre["v"], 0, base)
            elif auto_hit:
                # automatic prefix-cache hit: seed the matched blocks (one
                # contiguous chain from position 0), then chunk-prefill only
                # the suffix
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype, device=self.device)
                cache1 = _seed_run(cache1, [e["value"]["k"] for e in auto_hit],
                                   [e["value"]["v"] for e in auto_hit], 0)
                cache1["length"] = torch.full((1,), base, dtype=torch.int32,
                                              device=self.device)
                embeds = embeds[:, base:]
                length -= base
            elif length <= C:
                self._admit_whole(req, embeds, length, cache_key)
                return False
            else:
                cache1 = llama.init_kv_cache(self.cfg.llm, 1, self.cache_len,
                                             dtype=self.compute_dtype, device=self.device)
            # "length"/"off" are suffix-relative; "base" is the shared-prefix
            # KV already seeded into cache1
            self._admission = {"req": req, "embeds": embeds, "length": length,
                               "base": base, "off": 0, "cache1": cache1,
                               "last_logits": None, "cache_key": cache_key}
        a = self._admission
        C = self.prefill_chunk_len
        off = a["off"]
        end = min(off + C, a["length"])
        # pad the chunk to a power of two (at least 8), capped by C and by
        # the cache room (padded rows must land inside the cache)
        want = end - off
        Cc = min(max(8, 1 << (want - 1).bit_length()), C,
                 self.cache_len - a["base"] - off)
        end = off + min(want, Cc)
        chunk = a["embeds"][:, off:off + Cc]
        if chunk.shape[1] < Cc:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, Cc - chunk.shape[1]))
        logits, a["cache1"] = self._prefill_chunk(a["cache1"], chunk,
                                                  self._prefill_params(a["req"]))
        self.chunk_rows[Cc] += 1
        a["last_logits"] = logits
        a["last_off"] = off
        a["off"] = end
        # the padded tail advanced length too far; pin it to the true position
        a["cache1"]["length"] = torch.full((1,), a["base"] + end, dtype=torch.int32,
                                           device=self.device)
        if end >= a["length"]:
            self._finish_admission()
        return self._admission is not None

    def _finish_admission(self) -> None:
        a, self._admission = self._admission, None
        slot_idx = self._free_slot()
        if slot_idx is None:   # raced out of slots; requeue
            self.pending.put(a["req"])
            return
        last_in_chunk = a["length"] - 1 - a["last_off"]
        row = a["last_logits"][0, last_in_chunk].cpu().numpy()
        k, v = a["cache1"]["k"][:, 0], a["cache1"]["v"][:, 0]
        self._activate(a["req"], slot_idx, row, k, v, a["base"] + a["length"],
                       a["cache_key"])

    def _admit_whole(self, req: Request, embeds, length: int, cache_key=None) -> None:
        slot_idx = self._free_slot()
        if slot_idx is None:
            self.pending.put(req)
            return
        row, k, v = self._prefill(embeds, length, self._prefill_params(req))
        self._activate(req, slot_idx, row.cpu().numpy(), k, v, length, cache_key)

    def _activate(self, req: Request, slot_idx: int, logits_row, k, v, length: int,
                  cache_key) -> None:
        """Admission's common tail: first token, prefix blocks, the KV into
        the slot, penalty rows, and the slot goes live."""
        first = self._first_token(req, logits_row)
        self._cache_prompt_blocks(req, k, v, length, cache_key)
        self.cache = _insert(self.cache, k[:, :length], v[:, :length], slot_idx, length)
        self._host_len[slot_idx] = length
        self.cur_tokens[slot_idx] = first
        gid = req.grammar_id
        self.gram_state[slot_idx] = (0 if gid is None
                                     else int(self._g_nxt_h[self._g_offsets[gid], first]))
        self._seed_penalty_rows(req, slot_idx, first)
        self._assign_adapter(slot_idx, req)
        slot = _Slot(req)
        slot.generated.append(first)
        slot.budget -= 1          # the prefill-sampled token counts toward the budget
        self.slots[slot_idx] = slot
        req.out_queue.put([first])
        if slot.budget <= 0:
            self._retire(slot_idx)

    def _cache_prompt_blocks(self, req: Request, k_full, v_full, length: int,
                             cache_key=None) -> None:
        """Feed the just-prefilled prompt's full blocks to the prefix cache,
        keyed by ``cache_key`` (input_ids, or the fused identity stream).
        Explicit-prefix and adapted requests never cache (their KV is not a
        function of the key alone). k/v_full: [L, S, KVH, hd]."""
        pc = self.prefix_cache
        if (pc is None or cache_key is None or req.prefix_id is not None
                or req.adapter_id):
            return
        blk = pc.block
        for b, digest, parent in pc.missing_blocks(cache_key, length):
            kb = _slice_block(k_full, b * blk, blk=blk)
            vb = _slice_block(v_full, b * blk, blk=blk)
            pc.put(digest, parent, {"k": kb, "v": vb},
                   kb.numel() * kb.element_size() + vb.numel() * vb.element_size())

    def prefix_cache_stats(self) -> Optional[dict]:
        return None if self.prefix_cache is None else self.prefix_cache.stats()

    def metrics_summary(self) -> dict:
        """Serving metrics over the last 512 completed requests: TTFT
        percentiles (submit -> first token, queue time included) and decode
        throughput, on the host clock."""
        m = list(self._metrics)
        if not m:
            return {"completed": 0}
        ttft = np.sort(np.asarray([x[0] for x in m]))
        toks = sum(x[1] for x in m)
        dec_t = sum(x[2] for x in m)
        q = lambda p: float(ttft[min(len(ttft) - 1, int(p * (len(ttft) - 1)))])  # noqa: E731
        return {"completed": len(m), "tokens": int(toks),
                "ttft_p50_s": round(q(0.5), 4),
                "ttft_p95_s": round(q(0.95), 4),
                "decode_tok_s_per_req": round(toks / dec_t, 2),
                "uptime_s": round(time.monotonic() - self._t_start, 1)}

    def _seed_penalty_rows(self, req: Request, slot_idx: int, first: int) -> None:
        """Reset this slot's penalty state at admission (prompt presence,
        counts seeded with the first token); skipped for penalty-free
        requests, whose knob rows are identity."""
        if not self._request_has_penalties(req):
            return
        self.prompt_mask[slot_idx] = torch.from_numpy(
            self._prompt_presence(req)).to(self.device)
        self.gen_counts[slot_idx] = 0
        self.gen_counts[slot_idx, first] += 1

    @staticmethod
    def _request_has_penalties(req: Request) -> bool:
        return (req.repetition_penalty != 1.0 or req.presence_penalty != 0.0
                or req.frequency_penalty != 0.0)

    def _prompt_presence(self, req: Request) -> np.ndarray:
        """[V] bool presence of prompt tokens (image sentinels dropped)."""
        present = np.zeros((self._vocab_size,), bool)
        ids = np.asarray(req.input_ids)
        present[ids[(ids >= 0) & (ids < self._vocab_size)]] = True
        return present

    def _first_token(self, req: Request, logits_row: np.ndarray) -> int:
        """Sample the prefill's next token on the host with numpy, in float64,
        with the decode step's chain: grammar mask, penalties (prompt-only at
        this point), temperature, top_k, top_p, min_p; logprob entries when
        asked."""
        if req.grammar_id is not None:
            logits_row = np.where(self._g_allowed_h[self._g_offsets[req.grammar_id]],
                                  logits_row, -np.inf)
        if req.repetition_penalty != 1.0:
            present = self._prompt_presence(req)
            rep = req.repetition_penalty
            adj = np.where(logits_row > 0, logits_row / rep, logits_row * rep)
            logits_row = np.where(present, adj, logits_row)
        # presence/frequency penalties count generated tokens only: zero here

        def _done(tok: int) -> int:
            if req.logprobs:
                r64 = logits_row.astype(np.float64)
                lp = r64 - np.log(np.sum(np.exp(r64 - r64.max()))) - r64.max()
                n = min(req.logprobs, 8)
                top = np.argsort(lp)[::-1][:n]
                req.logprob_entries.append({
                    "logprob": float(lp[tok]),
                    "top": [(int(t), float(lp[t])) for t in top]})
            return tok

        if req.temperature <= 0.0:
            return _done(int(np.argmax(logits_row)))
        x = logits_row.astype(np.float64) / max(req.temperature, 1e-6)
        if req.top_k > 0:
            order = np.argsort(x)[::-1]
            kth = x[order[min(req.top_k, x.size) - 1]]
            x = np.where(x < kth, -np.inf, x)
        if req.top_p < 1.0:
            order = np.argsort(x)[::-1]
            xs = x[order]
            p = np.exp(xs - xs[0])
            p /= p.sum()
            keep = (np.cumsum(p) - p) < req.top_p   # exclusive-cum rule
            x = np.where(x < xs[keep][-1], -np.inf, x)
        if req.min_p > 0.0:
            p = np.exp(x - np.nanmax(x[np.isfinite(x)]))
            p /= p.sum()
            x = np.where(p < req.min_p * p.max(), -np.inf, x)
        p = np.exp(x - x.max())
        p /= p.sum()
        return _done(int(self._np_rng.choice(x.size, p=p)))

    def _retire(self, idx: int) -> None:
        slot = self.slots[idx]
        if slot is not None:
            now = time.monotonic()
            t_sub = getattr(slot.req, "_t_submit", slot.t_first)
            self._metrics.append((slot.t_first - t_sub,            # TTFT
                                  len(slot.generated),
                                  max(now - slot.t_first, 1e-9)))  # decode wall time
            slot.req.out_queue.put(None)
        self.slots[idx] = None
        if self._slot_adapter[idx]:
            self._slot_adapter[idx] = 0
            self._refresh_lora_view()

    def tick(self) -> int:
        """Advance admissions (one chunk) and run one decode dispatch for all
        active slots. Returns the number of active slots after it. Under a
        mesh every rank ticks together: rank 0's operations are broadcast
        and applied first."""
        with torch.no_grad(), fp32_accumulation(), use_mesh(self.mesh):
            if self.mesh is not None:
                self._exchange_ops()
                if self._stop.is_set():
                    return 0
            return self._tick()

    def _tick(self) -> int:
        # drain the overlapped dispatch before anything that mutates slot
        # or queue state, so emits stay in order
        if self._inflight is not None and (
                self._cancel_ids or not self.pending.empty()
                or self._admission is not None):
            self._flush_inflight()
        self._apply_cancellations()
        # one admission chunk per tick bounds added decode latency
        in_flight = self._admission_step()
        while not in_flight and not self.pending.empty() \
                and self._free_slot() is not None:
            in_flight = self._admission_step()
            if self._admission is not None:
                break

        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self._flush_inflight()   # tokens for retired slots are discarded
            return 1 if (in_flight or self._admission is not None) else 0

        # EOS as the very first sample
        eos = self.cfg.eos_token_id
        for i in list(active):
            s = self.slots[i]
            if s.generated and s.generated[-1] == eos:
                s.generated.pop()
                self._retire(i)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0

        B = self.max_slots
        knobs = np.zeros((8, B), np.float32)
        knobs[2] = 1.0                       # top_p default
        knobs[5] = 1.0                       # repetition_penalty default
        for i in active:
            r = self.slots[i].req
            knobs[:, i] = (r.temperature, 1.0, r.top_p, r.top_k, r.min_p,
                           r.repetition_penalty, r.presence_penalty, r.frequency_penalty)
        # filters cost a [B, V] sort per step and penalties read the [B, V]
        # count state: each runs only when an active slot asks
        use_filters = bool(any(knobs[0, i] > 0.0
                               and (knobs[2, i] < 1.0 or knobs[3, i] > 0
                                    or knobs[4, i] > 0.0) for i in active))
        use_penalties = bool(any(knobs[5, i] != 1.0 or knobs[6, i] != 0.0
                                 or knobs[7, i] != 0.0 for i in active))
        n_lp = min(8, max((self.slots[i].req.logprobs for i in active), default=0))
        use_grammar = any(self.slots[i].req.grammar_id is not None for i in active)

        idle = self._admission is None and self.pending.empty()
        if (self.draft_params is not None and idle and not use_penalties and n_lp == 0
                and not use_grammar and not self._use_lora
                and all((self.slots[i].req.temperature == 0.0
                         or (self.slots[i].req.top_k == 0 and self.slots[i].req.min_p == 0.0))
                        and self.slots[i].budget > 1
                        and int(self._host_len[i]) + self.spec_k + 2 <= self.cache_len
                        for i in active)):
            if self._inflight is not None:
                # spec emits must not reorder with a plain dispatch's: read
                # it, and gate again on the slots it leaves
                self._flush_inflight()
                return sum(s is not None for s in self.slots)
            if self._spec_tick(active):
                return sum(s is not None for s in self.slots)
        # tokens already dispatched but not yet pulled (overlapped mode)
        k_prev = self._inflight[1] if self._inflight is not None else 0
        min_budget = min(self.slots[i].budget for i in active)
        k = min(self.multi_step, max(min_budget - k_prev, 1)) if idle else 1
        top = int(max(self._host_len[i] for i in active)) + k_prev
        # no row writes past the pool (JAX drops such writes)
        k = max(1, min(k, self.cache_len - top))
        meta = self._upload(knobs.reshape(-1))
        # window: the smallest multiple of 256 that covers every active slot
        # through this dispatch; _host_len can be k_prev tokens stale
        need = top + k + 1
        window = min(self.cache_len, -(-need // 256) * 256)
        packed = self._step_k(meta, k, window, use_filters, use_penalties, n_lp,
                              use_grammar)
        self.decode_steps += k
        handle = self._pull(packed)

        # overlapped decode: in the steady idle regime keep this dispatch in
        # flight and process the previous one while the device runs
        snapshot = [self.slots[i] for i in active]
        overlap = (idle and k > 1 and min_budget - k_prev > k
                   and need + self.multi_step < self.cache_len)
        prev, self._inflight = self._inflight, None
        if overlap:
            self._inflight = (handle, k, active, snapshot, n_lp)
            if prev is None:
                return sum(s is not None for s in self.slots)
            if self._emit_packed(*prev):
                # the slot set changed under the in-flight dispatch; drain it
                self._flush_inflight()
        else:
            if prev is not None:
                self._emit_packed(*prev)
            self._emit_packed(handle, k, active, snapshot, n_lp)
        return sum(s is not None for s in self.slots)

    def _flush_inflight(self) -> None:
        """Pull and process the overlapped dispatch, if any."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._emit_packed(*prev)

    def _emit_packed(self, handle, k: int, active: List[int], snapshot, n_lp: int) -> bool:
        """Read one dispatch's packed result and credit tokens to its slots.
        Returns True if any slot retired. Slots retired or reassigned since
        the dispatch are skipped by identity."""
        host, event = handle
        if event is not None:
            event.synchronize()
        packed = host.numpy()
        B = self.max_slots
        eos = self.cfg.eos_token_id
        out_np = packed[:B * k].reshape(B, k)
        lengths = packed[B * k:B * k + B]
        lp_ids = lp_vals = lp_samp = None
        if n_lp:
            o = B * k + B
            lp_ids = packed[o:o + B * k * n_lp].reshape(B, k, n_lp)
            o += B * k * n_lp
            lp_vals = packed[o:o + B * k * n_lp].view(np.float32).reshape(B, k, n_lp)
            o += B * k * n_lp
            lp_samp = packed[o:o + B * k].view(np.float32).reshape(B, k)

        retired = False
        for i, snap in zip(active, snapshot):
            s = self.slots[i]
            if s is not snap:   # retired/reassigned since dispatch: discard
                continue
            self._host_len[i] = lengths[i]
            emit = []
            for t in out_np[i].tolist():
                if t == eos:
                    s.budget = 0
                    break
                emit.append(int(t))
                s.budget -= 1
                if s.budget <= 0:
                    break
            if emit:
                if s.req.logprobs and lp_ids is not None:
                    n = s.req.logprobs
                    for j in range(len(emit)):
                        s.req.logprob_entries.append({
                            "logprob": float(lp_samp[i, j]),
                            "top": list(zip(lp_ids[i, j, :n].tolist(),
                                            lp_vals[i, j, :n].tolist()))})
                s.generated.extend(emit)
                s.req.out_queue.put(emit)
                # plain tokens bypassed the draft cache: reseed it before the
                # next speculative tick
                s.draft = None
            if s.budget <= 0 or int(lengths[i]) >= self.cache_len - 1:
                self._retire(i)
                retired = True
        return retired

    def _spec_tick(self, active: List[int]) -> bool:
        """Speculative rounds for every active slot in one dispatch and one
        pull. Returns False (the caller takes the plain step) when a draft
        cannot be seeded for lack of cache room.

        The draft is text-only: a multimodal request's draft context holds
        pad (id 0) in place of the image sentinel, which costs acceptance,
        never exactness (the verify chunk corrects every rejected draft)."""
        eos = self.cfg.eos_token_id
        R, K, B = self.spec_rounds, self.spec_k, self.max_slots
        for i in active:                     # seed missing or invalidated drafts
            s = self.slots[i]
            if s.draft is None:
                ids = np.asarray(s.req.input_ids).copy()
                ids[ids < 0] = 0
                ctx = np.concatenate([ids, np.asarray(s.generated[:-1], ids.dtype)])
                if ctx.size == 0 or ctx.size + s.budget + K + 2 >= self.cache_len:
                    return False
                k, v = self._draft_prefill(ctx)
                self._d_insert(k, v, i, int(ctx.size))
                self.spec_stats["draft_prefills"] += 1
                s.draft = {"len": int(ctx.size)}
        meta = np.zeros((3, B), np.int32)
        sknobs = np.zeros((2, B), np.float32)
        sknobs[1] = 1.0
        for i in active:
            s = self.slots[i]
            meta[:, i] = (s.draft["len"], s.budget, 1)
            sknobs[:, i] = (s.req.temperature, s.req.top_p)
        use_sampling = bool((sknobs[0] > 0).any())
        # every live slot emits at least one token a round: no slot outlives
        # the largest budget's rounds
        rounds = min(R, max(self.slots[i].budget for i in active))
        # the window covers every target slot and draft through all rounds
        need = max(max(int(self._host_len[i]), int(meta[0, i])) for i in active) \
            + rounds * (K + 1) + 2
        window = min(self.cache_len, -(-need // 256) * 256)
        packed = self._spec_rounds(self._upload(meta.reshape(-1)), rounds, window,
                                   self._upload(sknobs.reshape(-1)), use_sampling)
        self.spec_stats["dispatches"] += 1
        self.spec_stats["rounds"] += rounds
        host, event = self._pull(packed)
        if event is not None:
            event.synchronize()
        packed = host.numpy()
        lengths = packed[:B]
        accs = packed[B:B + R * B].reshape(R, B)
        toks = packed[B + R * B:].reshape(R, B, K + 1)
        for i in active:
            s = self.slots[i]
            self._host_len[i] = int(lengths[i])
            emit = []
            cut = False                      # EOS or the budget landed mid-round
            for r in range(R):
                acc = int(accs[r, i])
                if acc < 0:                  # the slot had stopped
                    break
                self.spec_stats["slot_rounds"] += 1
                self.spec_stats["accepted"] += acc
                e_r = 0
                for t in toks[r, i, :acc + 1].tolist():
                    if t == eos:
                        s.budget = 0
                        break
                    emit.append(int(t))
                    s.budget -= 1
                    e_r += 1
                    if s.budget <= 0:
                        break
                s.draft["len"] += e_r
                if e_r < acc + 1:
                    cut = True
                if cut or s.budget <= 0:
                    break
            if cut:
                s.budget = 0      # the slot retires now; the advance past the cut is moot
            if emit:
                s.generated.extend(emit)
                s.req.out_queue.put(emit)
            if s.budget <= 0 or int(lengths[i]) >= self.cache_len - K - 2:
                self._retire(i)
        return True

    # ------------------------------------------------------------------
    def run_forever(self, idle_sleep: float = 0.005) -> None:
        while not self._stop.is_set():
            try:
                n = self.tick()
            except Exception:  # noqa: BLE001 — fail in-flight work, keep serving
                traceback.print_exc()
                if self._admission is not None:
                    self._admission["req"].out_queue.put(None)
                    self._admission = None
                n = 0
            if n == 0 and self.pending.empty() and not self._ops:
                time.sleep(idle_sleep)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the engine thread; under a mesh rank 0 also ends the other
        ranks' ``follow()`` (one last tick broadcasts the stop)."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._leader():
            self._defer(("stop", None))
            with torch.no_grad(), use_mesh(self.mesh):
                self._exchange_ops()
