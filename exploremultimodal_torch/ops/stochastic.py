"""Stochastic ops: the random streams of a training step, DropPath, and
integer-threshold hidden dropout.

Counterpart of `exploremultimodal_tpu/ops/stochastic.py`. JAX draws its bits
from `make_rng` streams; the port draws them from a `torch.Generator` that
the trainer owns, handed down the forward as a `StepRng`. A forward without
one is deterministic, as JAX's `deterministic=True`. Each op's plain
function takes its random bits as an argument, so tests can feed it the bits
JAX drew.
"""

from __future__ import annotations

import contextlib

import torch

_SEED_LOW, _SEED_HIGH = -2**31, 2**31
# the row indices of `StepRng.row_index`, by (rows, runs, rank, world,
# device): made once, read by the kernels at every step
_ROW_INDEX: dict = {}


class StepRng:
    """The random streams of one training step.

    `generator` lives on the compute device and draws the hidden-dropout
    bits, the DropPath masks and the ITM negatives; a process of a group
    seeds its own (the trainer: seed + data coordinate, as JAX's
    `initialize_runtime` seeds each process's host generators with its
    index), so tensor peers, which run the same rows, draw the same. The attention-dropout hash takes
    one int32 seed per attention call: they are drawn together for the
    step, on the host generator `seed_generator`, and copied to the device
    once, so no attention call waits on the host, and the same host seed
    gives the same masks on every device and every rank. A rank's rows
    differ from another's by their index in the global batch
    (`row_index`, from the rank's data coordinate `rank` of the data
    axis's `world` processes), which keys the hash as JAX's step over the
    whole batch keys it; under tensor parallelism the attention call adds
    its heads' offset."""

    def __init__(self, generator: torch.Generator, seed_generator: torch.Generator,
                 device: torch.device, max_attention_calls: int = 256, *,
                 rank: int = 0, world: int = 1):
        self.generator = generator
        seeds = torch.randint(_SEED_LOW, _SEED_HIGH, (max_attention_calls,),
                              dtype=torch.int32, generator=seed_generator)
        if device.type == "cuda":
            seeds = seeds.pin_memory()
        self._seeds = seeds.to(device, non_blocking=True)
        self.attention_calls = 0
        self.rank, self.world = rank, world
        self.row_runs = 1

    def row_index(self, rows: int, device: torch.device) -> torch.Tensor | None:
        """The global index of each of an attention call's `rows` rows, as
        (rows,) int32 on `device`, or None at one process (each row is its
        own). A call's rows are `row_runs` runs of equal length R, the
        process's share of each run of the global batch: row j of run k is
        k * world * R + rank * R + j (one run for a stream over the batch,
        three for ITM's [pos, img-neg, txt-neg] pair rows)."""
        if self.world == 1:
            return None
        key = (rows, self.row_runs, self.rank, self.world, device)
        idx = _ROW_INDEX.get(key)
        if idx is None:
            per = rows // self.row_runs
            run = torch.arange(self.row_runs)[:, None] * (self.world * per)
            idx = (run + self.rank * per + torch.arange(per)).reshape(-1)
            idx = _ROW_INDEX[key] = idx.to(device=device, dtype=torch.int32)
        return idx

    @contextlib.contextmanager
    def runs(self, count: int):
        """Attention calls inside take their rows as `count` runs
        (`row_index`)."""
        old, self.row_runs = self.row_runs, count
        try:
            yield
        finally:
            self.row_runs = old

    def state(self) -> tuple:
        """What the next draws depend on: the attention calls so far, the
        generator's state and the row layout."""
        return self.attention_calls, self.generator.get_state(), self.row_runs

    def restore(self, state: tuple) -> None:
        self.attention_calls, gen, self.row_runs = state
        self.generator.set_state(gen)

    def replay(self) -> "Replay":
        """A context that draws, each time it is entered, what the first
        entry drew: for a forward that a checkpoint runs again in the
        backward (`models.vlmo.Block`)."""
        return Replay(self)

    def attention_seed(self) -> torch.Tensor:
        """The next attention call's seed: one int32 on the device."""
        i = self.attention_calls
        if i >= self._seeds.numel():
            raise RuntimeError(
                f"more than {self._seeds.numel()} attention-dropout calls in "
                "one step: raise StepRng's max_attention_calls")
        self.attention_calls += 1
        return self._seeds[i:i + 1]


class Replay:
    """Entered the first time, a no-op that notes the streams' state;
    entered again (a recomputed forward), it rewinds the streams to that
    state, and on exit puts back the state they had at the entry, so the
    draws after the recomputation are those an uncheckpointed step makes."""

    def __init__(self, rng: StepRng):
        self.rng = rng
        self.start = rng.state()
        self.entered = False
        self.resume = None

    def __enter__(self):
        if self.entered:
            self.resume = self.rng.state()
            self.rng.restore(self.start)
        self.entered = True
        return self

    def __exit__(self, *exc):
        if self.resume is not None:
            self.rng.restore(self.resume)
            self.resume = None
        return False


def drop_path_plain(x: torch.Tensor, rate: float, keep: torch.Tensor) -> torch.Tensor:
    """Zero the whole residual branch of each sample where `keep` (B,) is
    False, scale the rest by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    scaled = x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, rng: StepRng | None) -> torch.Tensor:
    """DropPath with a Bernoulli(1 - rate) keep per sample; identity when
    `rng` is None (deterministic) or the rate is 0."""
    if rng is None or rate == 0.0:
        return x
    u = torch.rand((x.shape[0],), generator=rng.generator, device=x.device)
    return drop_path_plain(x, rate, u < 1.0 - rate)


def dropout_threshold16(rate: float) -> int:
    """FastDropout's uint16 threshold: keep where bits >= round(rate * 65536)."""
    return int(round(rate * 65536.0))


def keep_scale16(threshold: int) -> float:
    """The kept elements' factor 65536 / (65536 - t)."""
    return 65536.0 / (65536 - threshold)


def bits16(rng: StepRng, shape, device: torch.device,
           share: tuple[int, int] | None = None) -> torch.Tensor:
    """Uniform uint16 draws u (JAX's `jax.random.bits(..., uint16)`) on
    `rng.generator`, stored in 2 bytes as the int16 u - 32768: the order of
    the unsigned values is kept, so one signed comparison (`keep16`) reads
    u >= t, and the bit pattern is u with its top bit flipped. With `share`
    = (t, T), a tensor rank's columns of a hidden split T ways: the draw of
    the whole last axis (T times `shape`'s), of which columns t W .. (t +
    1) W - 1, W = shape[-1], so the mask is the one-process step's (at T
    times the draws)."""
    shape = tuple(shape)
    if share is None:
        return torch.randint(-32768, 32768, shape, dtype=torch.int16,
                             generator=rng.generator, device=device)
    t, n = share
    width = shape[-1]
    whole = torch.randint(-32768, 32768, shape[:-1] + (n * width,), dtype=torch.int16,
                          generator=rng.generator, device=device)
    return whole[..., t * width:(t + 1) * width]


def keep16(bits: torch.Tensor, threshold: int) -> torch.Tensor:
    """The keep mask u >= t of uint16 draws u stored as `bits16` stores them
    (the int16 u - 32768)."""
    return bits >= threshold - 32768


def fast_dropout_plain(x: torch.Tensor, rate: float, bits: torch.Tensor) -> torch.Tensor:
    """`FastDropout` with given uint16 draws `bits` (stored as `bits16`
    stores them, x's shape): keep where bits >= t = round(rate * 65536),
    scaled by 65536 / (65536 - t) in x's dtype."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    t = dropout_threshold16(rate)
    if t == 0:
        return x
    scale = torch.tensor(keep_scale16(t), dtype=x.dtype, device=x.device)
    return torch.where(keep16(bits, t), x * scale, torch.zeros_like(x))


def fast_dropout(x: torch.Tensor, rate: float, rng: StepRng | None,
                 share: tuple[int, int] | None = None) -> torch.Tensor:
    """Hidden dropout from uint16 bits drawn on `rng.generator` (a tensor
    rank's columns of the whole draw with `share`, as `bits16`); identity
    when `rng` is None or the rate is 0."""
    if rng is None or dropout_threshold16(rate) == 0:
        return x
    bits = (bits16(rng, x.shape, x.device) if share is None
            else bits16(rng, x.shape, x.device, share=share))
    return fast_dropout_plain(x, rate, bits)
