"""Batched serving engine: slot-based continuous batching.

Port of ``src/repro/serve/engine.py`` (``ServeEngine``, ``Request``):

  * a fixed pool of ``slots`` (the decode batch) with per-slot lengths —
    decode steps run in lockstep over all slots, per-slot masks handle
    ragged lengths;
  * prompts are prefilled one at a time into a free slot through the
    flash kernel (``impl``; ``"naive"`` is the plain path, for parity
    checks); an attention-only model's prompt is right-padded to a
    multiple of 16 (causal-safe), a model with any recurrent block is
    prefilled at its exact length (its state would absorb every pad);
    generation joins the next decode step;
  * finished slots (EOS, ``max_new`` or ``max_len``) are recycled at once.

Where the reference rebuilds its caches functionally, the port writes them
in place: a prefill's single-row caches are copied into the slot's row of
the pool, leaf by leaf (K/V, MLA's latent ``ckv`` and rope key ``kr``,
the shared blocks' K/V and the recurrent states, each in its own dtype),
and each decode step writes one position per slot and steps every
recurrent state.  Per-slot lengths and last
tokens live on the host and go to the device with each step.  Sampled
decoding draws from a ``torch.Generator`` seeded with ``seed``; greedy
decoding takes the argmax.

``mesh=`` (``dp_axes``, ``model_axis``: a ``launch.mesh.Mesh`` bound to
``torch.distributed``, one process per entry) serves over the mesh with
the reference's control flow: every rank builds the same engine from the
same placed parameters and submits the same requests.  The slots split
over the dp axes in contiguous blocks (``_rows``): the pool is
``init_caches(mesh=)`` over the global ``slots``, each rank holding its
dp block's rows (every slot where ``slots`` does not divide over the dp
axes), every kv head and its block of the sequence (``cache_specs``'
layout), and its model rank's recurrent heads.  A prompt's one-row
prefill (``lm_prefill(mesh=, cache_batch=slots)``: its row whole on every
dp rank, tensor-parallel over the model axis, its caches in the pool's
blocks of the sequence) is spliced into the slot's row by the ranks whose
block holds it.  Prefill logits are taken from dp rank 0 and decode
logits gathered over the dp axes, so every rank samples the same tokens
from the same global logits (the generator seeded alike) and holds the
same lengths, last tokens and request outputs.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as col
from repro_torch.models.layers import shard_axes
from repro_torch.models.transformer import (_batch_axes, init_caches,
                                            lm_decode_step, lm_prefill)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 32
    eos_id: int | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 8, max_len: int = 512,
                 mesh=None, dp_axes=("data",), model_axis="model",
                 greedy: bool = True, seed: int = 0, impl: str = "chunked"):
        self.cfg = cfg
        self.impl = impl
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.mesh = mesh
        self.greedy = greedy
        self.device = col.local(params["embed"]).device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._rid = itertools.count()
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        self.lengths = np.zeros((slots,), np.int64)
        self.last_tok = np.zeros((slots,), np.int64)
        self._mesh_kw = self._decode_kw = self._prefill_kw = {}
        self._rows = (0, slots)
        self._dp = self._dp_all = ()
        if mesh is not None:
            self._mesh_kw = dict(mesh=mesh, dp_axes=dp_axes,
                                 model_axis=model_axis)
            self._decode_kw = dict(self._mesh_kw, max_len=max_len)
            self._prefill_kw = dict(self._mesh_kw, cache_batch=slots)
            self._dp_all = ((dp_axes,) if isinstance(dp_axes, str)
                            else tuple(dp_axes))
            self._dp = _batch_axes(slots, dp_axes, mesh)
            with shard_axes(self._dp, model_axis, mesh) as ax:
                n = slots // ax.dp_size
                self._rows = (ax.dp_index * n, (ax.dp_index + 1) * n)
        self.caches = init_caches(cfg, slots, max_len,
                                  params["embed"].dtype, device=self.device,
                                  **self._mesh_kw)

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new: int = 32, eos_id: int | None = None):
        req = Request(next(self._rid), np.asarray(prompt, np.int32),
                      max_new=max_new, eos_id=eos_id)
        self.queue.append(req)
        return req

    def _free_slot(self):
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    @staticmethod
    def _bucket(n, quantum=16):
        return max(quantum, -(-n // quantum) * quantum)

    @property
    def _attention_only(self):
        return all(k == "attn" for k in self.cfg.pattern)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.pop(0)
            S = len(req.prompt)
            if self._attention_only:
                # right-pad to a bucket boundary: pads sit in the masked
                # future
                padded = np.zeros((self._bucket(S),), np.int64)
                padded[:S] = req.prompt
                logits, caches1, _ = lm_prefill(
                    self.params, self.cfg, self._tensor(padded)[None],
                    max_len=self.max_len, impl=self.impl, last_index=S - 1,
                    **self._prefill_kw)
            else:
                # a recurrent state absorbs every token it sees: prefill
                # at the exact prompt length
                logits, caches1, _ = lm_prefill(
                    self.params, self.cfg, self._tensor(req.prompt)[None],
                    max_len=self.max_len, impl=self.impl,
                    **self._prefill_kw)
            lo, hi = self._rows
            if lo <= slot < hi:                           # the slot's row
                for key, stage in self.caches.items():
                    for name, full in stage.items():
                        full[:, slot - lo].copy_(caches1[key][name][:, 0])
            tok = int(self._sample(self._from_dp0(logits))[0])
            req.out.append(tok)
            self.active[slot] = req
            self.lengths[slot] = S
            self.last_tok[slot] = tok

    def _from_dp0(self, logits):
        """A prefill's logits, held whole on every dp rank, as dp rank 0
        computed them (each dp rank's model group computes its own copy):
        every rank then samples from the same bits."""
        if self.mesh is None:
            return logits
        logits = logits.contiguous()
        for axis in self._dp_all:
            if self.mesh.shape[axis] > 1:
                dist.broadcast(logits, self.mesh.axis_ranks(axis)[0],
                               group=self.mesh.group(axis))
        return logits

    def _global(self, logits):
        """A decode step's logits of this rank's slots as every slot's:
        gathered over the dp axes, or, where the slots are whole on every
        dp rank, dp rank 0's."""
        if self.mesh is None:
            return logits
        if self._dp:
            return col.gather(logits, self.mesh, 0, self._dp)
        return self._from_dp0(logits)

    def _sample(self, logits):
        if self.greedy:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float(), -1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    # -------------------------------------------------------------- step --
    def step(self):
        """Admit pending prompts, then decode one token for every active
        slot.  Returns the number of active requests."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        logits, self.caches = lm_decode_step(
            self.params, self.cfg, self._tensor(self.last_tok), self.caches,
            self._tensor(self.lengths), **self._decode_kw)
        toks = self._sample(self._global(logits)).tolist()
        self.lengths += [r is not None for r in self.active]
        self.last_tok[:] = toks
        for i, req in enumerate(self.active):
            if req is None:
                continue
            t = toks[i]
            req.out.append(t)
            hit_eos = req.eos_id is not None and t == req.eos_id
            if hit_eos or len(req.out) >= req.max_new \
                    or self.lengths[i] >= self.max_len - 1:
                req.done = True
                self.active[i] = None
                self.lengths[i] = 0
        return sum(r is not None for r in self.active)

    def run(self, max_steps: int = 10_000):
        """Drive until queue + slots drain."""
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self.queue:
                break
