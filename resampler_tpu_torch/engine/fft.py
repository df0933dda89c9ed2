"""FFT overlap-add resampler engine: PyTorch port of
``resampler_tpu/engine/fft.py``.

The whole per-chunk spectral pipeline of the reference
(reference: src/resampler_fft.rs:385-424: zero-pad, real FFT, Kaiser
filter spectrum, bin copy, inverse real FFT, overlap-add) is one linear
operator, designed once in float64 on the host and cached process-wide.
Backends, as in the JAX package:

- ``"magsplit"``: the banded magnitude-split projector, kernels B4 and B5
  (``ops/fft_magsplit_kernel.py``, ``csrc/fft_magsplit.cu``).  ``"auto"``
  takes it on the card wherever ``plan_magsplit`` has a plan for the pair
  (the JAX package's TPU rule: the hand-written kernel is the production
  path);
- ``"matmul"``: the dense ``[N, 2M]`` projector as one product:
  ``"auto"`` off the card and for pairs without a band plan;
- ``"conv"``: the channelized banded form, as a strided window view and one
  product (not ``conv1d``: cuDNN runs TF32 by default);

  on the card both products are kernel B7 in three bf16 passes
  (``ops/matmul3.py``, the weight split once per device), which is the JAX
  package's ``Precision.HIGH`` arithmetic on a device with bf16 passes; on
  the CPU, where JAX's ``Precision.HIGH`` is f32, they are float32
  ``torch.matmul`` (TF32 off);
- ``"fft"`` and ``"rfft"``: the reference dataflow on ``torch.fft``
  (``dsp/rfft.py`` exists in the JAX package only because TPU runtimes
  reject complex dtypes; it is not ported).

The carry is an explicit dict: ``{"overlap": [C, M]}`` for the spectral
forms, ``{"prev": [C, N]}`` (the previous chunk) for ``magsplit`` and
``conv``, with a leading ``[B]`` in the fleet forms.  Every function takes
``device=`` (the card by default; the CPU only when asked).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch

from ..dsp.planner import plan_conversion
from ..dsp.window import WindowType, calculate_cutoff_kaiser, make_sincs_for_kaiser
from ..ops.matmul3 import matmul3, split_weight
from ..types import InvalidInputBufferSize, InvalidOutputBufferSize, SampleRate
from .fir import resolve_device

__all__ = [
    "KAISER_BETA",
    "FftConfig",
    "FftState",
    "fft_init",
    "convert_fft_state",
    "make_fft_step",
    "make_fft_fleet_step",
    "make_fft_fleet_step_pool",
    "fft_fleet_init",
    "fft_fleet_pool_init",
    "spectral_projection_matrix",
    "input_domain_conv_operator",
    "conv_backend_viable",
    "fft_filter_spectrum",
    "get_projection_matrix",
    "ResamplerFft",
]

#: Kaiser window beta for ~-100 dB stopband
#: (reference: src/resampler_fft.rs:16).
KAISER_BETA = 10.0


@dataclasses.dataclass(frozen=True)
class FftConfig:
    """Static FFT engine configuration for one rate pair."""

    channels: int
    fft_size_input: int   # N: input samples per chunk per channel
    fft_size_output: int  # M: output samples per chunk per channel

    @property
    def delay(self) -> int:
        """Algorithmic latency in input samples = N/2
        (reference: src/resampler_fft.rs:147-153)."""
        return self.fft_size_input // 2


#: Carry dict: ``{"overlap": f32[C, M]}`` for the matmul/fft backends,
#: ``{"prev": f32[C, N]}`` (the previous chunk) for magsplit and conv:
#: the same information (``overlap = prev @ T[:, M:]``).
FftState = dict

_PREV_BACKENDS = ("conv", "magsplit")


def fft_init(config: FftConfig, backend: str = "auto", device="cuda") -> FftState:
    dev = resolve_device(device)
    backend = _resolve_backend(config, backend, dev)
    if backend in _PREV_BACKENDS:
        shape = (config.channels, config.fft_size_input)
        return {"prev": torch.zeros(shape, dtype=torch.float32, device=dev)}
    shape = (config.channels, config.fft_size_output)
    return {"overlap": torch.zeros(shape, dtype=torch.float32, device=dev)}


def convert_fft_state(
    state: FftState, config: FftConfig, backend: str, device="cuda"
) -> FftState:
    """Convert a carry dict to the schema ``backend`` expects.

    ``backend="auto"`` resolves per device, so a carry saved where
    magsplit (``{"prev"}``) is production may be restored where matmul
    (``{"overlap"}``) is.  ``prev -> overlap`` is exact up to f32 rounding
    (``overlap = prev @ T[:, M:]``, one f32 matmul, TF32 off); the reverse
    is not invertible: construct the resampler with an explicit
    ``backend`` matching the checkpoint instead."""
    dev = resolve_device(device)
    backend = _resolve_backend(config, backend, dev)
    want_prev = backend in _PREV_BACKENDS
    if ("prev" in state) == want_prev:
        return state
    if "prev" in state and not want_prev:
        n_out = config.fft_size_output
        proj = _projection_tensor(config.fft_size_input, n_out, dev)[:, n_out:]
        prev = torch.as_tensor(state["prev"], dtype=torch.float32).to(dev)
        return {"overlap": torch.matmul(prev, proj)}
    raise ValueError(
        "cannot convert an {'overlap'} carry to the input-domain "
        f"{backend!r} backend's {{'prev'}} state (the projection is not "
        "invertible); construct the resampler with backend='matmul' to "
        "restore this checkpoint"
    )


def _magsplit_plan(config: FftConfig):
    from ..ops.fft_magsplit_kernel import plan_magsplit

    return plan_magsplit(config.fft_size_input, config.fft_size_output)


def _resolve_backend(config: FftConfig, backend: str, device: torch.device) -> str:
    if backend == "auto":
        # On the card the hand-written magsplit kernel is the production
        # path wherever the pair's band geometry allows (the JAX
        # package's TPU rule); elsewhere the dense f32 projector is
        # (magsplit stays selectable there, on its plain version).
        if device.type == "cuda" and _magsplit_plan(config):
            return "magsplit"
        return "matmul"
    return backend


# --------------------------------------------------------------------------
# Filter + projection-matrix design (host, float64, cached)
# --------------------------------------------------------------------------


def fft_filter_spectrum(n_in: int, n_out: int) -> np.ndarray:
    """Kaiser filter spectrum of the overlap-add filter, float64.

    Matches the reference design (reference: src/resampler_fft.rs:338-383):
    cutoff from Kaiser theory at size ``min(n_in, n_out)``, scaled by
    ``n_out/n_in`` when downsampling; periodic window; time-domain filter
    normalized by ``1/(2*n_in)`` (folding the unnormalized-FFT round-trip
    scale into the filter); spectrum = rFFT of the zero-padded filter.
    Returns ``[n_in + 1]`` complex128 bins.
    """
    if n_in > n_out:
        scale = n_out / n_in
        cutoff = calculate_cutoff_kaiser(n_out, KAISER_BETA) * scale
    else:
        cutoff = calculate_cutoff_kaiser(n_in, KAISER_BETA)

    sincs = make_sincs_for_kaiser(
        n_in, 1, float(np.float32(cutoff)), KAISER_BETA, WindowType.PERIODIC
    ).astype(np.float64)[0]
    filter_time = np.zeros(2 * n_in, np.float64)
    filter_time[:n_in] = sincs / (2 * n_in)
    return np.fft.rfft(filter_time)


def spectral_projection_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The fused ``[n_in, 2*n_out]`` float32 chunk operator ``T``.

    ``chunk_out_full = chunk_in @ T`` equals the reference per-chunk
    pipeline (reference: src/resampler_fft.rs:385-415): zero-pad to 2N,
    unnormalized rFFT, multiply the first ``new_length`` bins by the filter
    spectrum, copy them into a ``n_out+1``-bin spectrum (rest zero),
    unnormalized inverse rFFT at 2M.  Built column-exactly by pushing the
    identity basis through the (linear) pipeline with f64 numpy FFTs.
    """
    filt = fft_filter_spectrum(n_in, n_out)
    new_length = n_in + 1 if n_in < n_out else n_out

    basis = np.zeros((n_in, 2 * n_in), np.float64)
    basis[:, :n_in] = np.eye(n_in)
    spectrum = np.fft.rfft(basis, axis=1)  # unnormalized forward
    spectrum = spectrum[:, :new_length] * filt[:new_length]

    out_spec = np.zeros((n_in, n_out + 1), np.complex128)
    out_spec[:, :new_length] = spectrum
    # numpy irfft normalizes by 1/(2M); the reference inverse FFT is
    # unnormalized, so scale back by 2M.
    time = np.fft.irfft(out_spec, n=2 * n_out, axis=1) * (2 * n_out)
    return np.ascontiguousarray(time, dtype=np.float32)


def input_domain_conv_operator(n_in: int, n_out: int) -> np.ndarray:
    """The projector as a **channelized strided convolution**:
    ``out_t = [x_{t-1}; x_t] @ T2``, ``T2 = [T[:, M:]; T[:, :M]]`` of
    shape ``[2N, M]``, has the shift structure ``T2[i + L', j + M'] =
    T2[i, j]`` (``L' = N/g``, ``M' = M/g``, ``g = gcd(N, M)``) and each
    column's support spans ``< (g+1)*L'`` rows.  So with ``[x_{t-1};
    x_t]`` viewed as ``2g`` blocks of ``L'`` channels and the
    ``[g+1, L', M']`` filter ``W = T2[:(g+1)*L', :M']``::

        out[c, k, j] = sum_{b, l} blocks[c, k+b, l] * W[b, l, j]

    FLOPs drop to ``(g+1)/(2g)`` of the dense projector.
    (reference chunk pipeline: src/resampler_fft.rs:385-424)
    """
    T = spectral_projection_matrix(n_in, n_out).astype(np.float64)
    T2 = np.vstack([T[:, n_out:], T[:, :n_out]])  # [2N, M] = [B; A]
    g = math.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g
    span = (g + 1) * lp
    return np.ascontiguousarray(
        T2[:span, :mp].reshape(g + 1, lp, mp), dtype=np.float32
    )


def conv_backend_viable(n_in: int, n_out: int) -> bool:
    """Whether the channelized conv form is well-shaped: the period must
    have >= 64 channels each way (L', M') and the band must cut FLOPs
    (g >= 2).  Well-shaped does not mean faster."""
    g = math.gcd(n_in, n_out)
    return g >= 2 and n_in // g >= 64 and n_out // g >= 64


_PROJ_CACHE: dict[tuple[int, int], np.ndarray] = {}
_PROJ_LOCK = threading.Lock()
_TENSOR_CACHE: dict[tuple, torch.Tensor | tuple[torch.Tensor, torch.Tensor]] = {}


def get_projection_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Process-wide cache of projection matrices, the analog of the
    reference's global FFT_CACHE (reference: src/resampler_fft.rs:34-36,
    305-335)."""
    key = (n_in, n_out)
    with _PROJ_LOCK:
        mat = _PROJ_CACHE.get(key)
        if mat is None:
            mat = spectral_projection_matrix(n_in, n_out)
            _PROJ_CACHE[key] = mat
    return mat


def _design_tensor(name: str, n_in: int, n_out: int, device: torch.device, make):
    """A host design array on ``device``, uploaded once per device."""
    key = (name, n_in, n_out, str(device))
    with _PROJ_LOCK:
        t = _TENSOR_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(make(n_in, n_out))).to(device)
        with _PROJ_LOCK:
            t = _TENSOR_CACHE.setdefault(key, t)
    return t


def _projection_tensor(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return _design_tensor("proj", n_in, n_out, device, get_projection_matrix)


def _split_design(name: str, n_in: int, n_out: int, device: torch.device, make):
    """A host design matrix's bf16 split ``(hi, lo)`` on ``device`` (B7's
    weight), made and uploaded once per device."""
    key = (name + ":split", n_in, n_out, str(device))
    with _PROJ_LOCK:
        pair = _TENSOR_CACHE.get(key)
    if pair is None:
        halves = split_weight(torch.from_numpy(np.ascontiguousarray(make(n_in, n_out))))
        with _PROJ_LOCK:
            pair = _TENSOR_CACHE.setdefault(key, tuple(h.to(device) for h in halves))
    return pair


# --------------------------------------------------------------------------
# Functional steps
# --------------------------------------------------------------------------


def _make_magsplit_op(config: FftConfig, device: torch.device):
    """``f(prev [R, N], cur [R, N], out=None) -> out [R, M]`` through
    kernel B4 on the card (its plain version on the CPU), into ``out``
    where given, and the plan and weights for the pool form."""
    from ..ops.fft_magsplit_kernel import magsplit_projector, magsplit_weights

    plan = _magsplit_plan(config)
    if plan is None:
        raise ValueError(
            "magsplit backend: pair "
            f"{config.fft_size_input}->{config.fft_size_output} has no "
            "viable band plan (use backend='matmul')"
        )
    wh, wcorr = magsplit_weights(plan, device)

    def chunk_op(prev, cur, out=None):
        return magsplit_projector(prev, cur, wh, wcorr, plan=plan, out=out)

    return chunk_op, plan, wh, wcorr


def _make_conv_op(config: FftConfig, device: torch.device):
    """``f(x2 [R, 2N]) -> out [R, M]``: the channelized banded form as a
    stride-``L'`` window view of ``x2`` and one product: B7 in three
    passes on the card, f32 ``torch.matmul`` on the CPU."""
    n_in, n_out = config.fft_size_input, config.fft_size_output
    g = math.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g

    if device.type == "cuda":
        w_hi, w_lo = _split_design(
            "conv", n_in, n_out, device,
            lambda a, b: input_domain_conv_operator(a, b).reshape((g + 1) * lp, mp),
        )

        def conv_op(x2):
            # windows [g, R, (g+1) L'] and out [R, g, M'] as [g, R, M']:
            # strided views, no copies
            x2 = x2.contiguous()
            R = x2.shape[0]
            out = x2.new_empty((R, g, mp))
            windows = x2.as_strided((g, R, (g + 1) * lp), (lp, 2 * n_in, 1))
            matmul3(windows, w_hi, w_lo, passes=3, out=out.permute(1, 0, 2))
            return out.reshape(R, n_out)

        return conv_op

    w = _design_tensor("conv", n_in, n_out, device, input_domain_conv_operator)
    w2 = w.reshape((g + 1) * lp, mp)

    def conv_op(x2):
        R = x2.shape[0]
        windows = x2.as_strided((R, g, (g + 1) * lp), (2 * n_in, lp, 1))
        return torch.matmul(windows, w2).reshape(R, n_out)  # [R, g, mp]

    return conv_op


def _make_spectral_op(config: FftConfig, backend: str, device: torch.device):
    """``f(x [R, N]) -> full [R, 2M]``: the dense projector (B7 in three
    passes on the card, f32 ``torch.matmul`` on the CPU) or the reference
    dataflow on ``torch.fft``."""
    n_in, n_out = config.fft_size_input, config.fft_size_output
    if backend == "matmul":
        if device.type == "cuda":
            t_hi, t_lo = _split_design("proj", n_in, n_out, device, get_projection_matrix)
            return lambda x: matmul3(x, t_hi, t_lo, passes=3)
        proj = _projection_tensor(n_in, n_out, device)
        return lambda x: torch.matmul(x, proj)
    if backend not in ("fft", "rfft"):
        raise ValueError(f"unknown FFT backend {backend!r}")
    new_length = n_in + 1 if n_in < n_out else n_out
    filt = torch.from_numpy(
        fft_filter_spectrum(n_in, n_out)[:new_length].astype(np.complex64)
    ).to(device)
    pad = n_out + 1 - new_length

    def chunk_op(x):
        spec = torch.fft.rfft(x, n=2 * n_in, dim=1)[:, :new_length] * filt
        if pad:
            spec = torch.cat([spec, spec.new_zeros((x.shape[0], pad))], dim=1)
        return torch.fft.irfft(spec, n=2 * n_out, dim=1) * (2 * n_out)

    return chunk_op


def make_fft_step(config: FftConfig, *, backend: str = "auto", device="cuda"):
    """Build the chunk step

    ``step(state, chunk [C, N] f32) -> (state', out [C, M] f32)``

    on ``device``.  The input-domain backends (magsplit, conv) keep the
    chunk itself as the next ``prev``, by reference: a caller of the step
    that writes into a chunk after passing it changes the carry.  The
    wrappers (``ResamplerFft``, ``BatchedResamplerFft``) hand it private
    copies."""
    dev = resolve_device(device)
    n_in, n_out = config.fft_size_input, config.fft_size_output
    backend = _resolve_backend(config, backend, dev)

    if backend == "magsplit":
        chunk_op = _make_magsplit_op(config, dev)[0]

        def step(state: FftState, chunk):
            chunk = chunk.to(torch.float32).contiguous()
            return {"prev": chunk}, chunk_op(state["prev"], chunk)

        return step

    if backend == "conv":
        conv_op = _make_conv_op(config, dev)

        def step(state: FftState, chunk):
            chunk = chunk.to(torch.float32)
            return {"prev": chunk}, conv_op(torch.cat([state["prev"], chunk], dim=1))

        return step

    chunk_op = _make_spectral_op(config, backend, dev)

    def step(state: FftState, chunk):
        full = chunk_op(chunk.to(torch.float32))
        out = full[:, :n_out] + state["overlap"]
        return {"overlap": full[:, n_out:].contiguous()}, out

    return step


def _rows(out, B: int, C: int, n_out: int):
    """A fleet step's ``out [B, C, M]`` as the projector's ``[B*C, M]``
    view of the same memory (``None`` stays ``None``)."""
    if out is None:
        return None
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"out must be a tensor, got {type(out).__name__}")
    if tuple(out.shape) != (B, C, n_out):
        raise ValueError(f"out must be [{B}, {C}, {n_out}], got {list(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out.view(B * C, n_out)


def make_fft_fleet_step(
    config: FftConfig, n_streams: int, *, backend: str = "auto", mesh=None,
    device="cuda",
):
    """Fleet-wide FFT step: ``streams x channels`` folded into the row
    dimension of ONE device op (one kernel launch or one matmul).
    ``step(state, chunks [B, C, N]) -> (state, out [B, C, M])``; state is
    ``{"prev": [B, C, N]}`` for magsplit and conv (held by reference, as
    in ``make_fft_step``), ``{"overlap": [B, C, M]}`` otherwise.  The
    magsplit step also takes ``out=``, a contiguous ``[B, C, M]`` f32
    tensor (a slot of a caller's ``[T, B, C, M]``) that kernel B4 stores
    into and the step returns (``magsplit_projector``'s conditions)."""
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet (ROADMAP A11)")
    dev = resolve_device(device)
    n_in, n_out = config.fft_size_input, config.fft_size_output
    C = config.channels
    B = n_streams
    backend = _resolve_backend(config, backend, dev)

    if backend == "magsplit":
        chunk_op = _make_magsplit_op(config, dev)[0]

        def step(state: FftState, chunks, *, out=None):
            chunks = chunks.to(torch.float32).contiguous()
            rows = _rows(out, B, C, n_out)
            out = chunk_op(
                state["prev"].reshape(B * C, n_in), chunks.reshape(B * C, n_in), rows
            )
            return {"prev": chunks}, out.reshape(B, C, n_out)

        return step

    if backend == "conv":
        conv_op = _make_conv_op(config, dev)

        def step(state: FftState, chunks):
            chunks = chunks.to(torch.float32)
            x2 = torch.cat([state["prev"], chunks], dim=2).reshape(B * C, 2 * n_in)
            return {"prev": chunks}, conv_op(x2).reshape(B, C, n_out)

        return step

    chunk_op = _make_spectral_op(config, backend, dev)

    def step(state: FftState, chunks):
        x = chunks.to(torch.float32).reshape(B * C, n_in)
        full = chunk_op(x).reshape(B, C, 2 * n_out)
        out = full[:, :, :n_out] + state["overlap"]
        return {"overlap": full[:, :, n_out:].contiguous()}, out

    return step


def make_fft_fleet_step_pool(
    config: FftConfig, n_streams: int, *, backend: str = "auto", device="cuda"
):
    """Zero-copy fleet step over a rotating chunk pool (the serving ingest
    form): producers write chunks into ``pool`` slots and kernel B5 reads
    ``prev`` and ``cur`` straight from their slots, with no per-step
    ``[B, C, N]`` staging copy.

    ``step(state, pool [P, B*C, N], idx, *, out=None) -> (state', out
    [B, C, M])`` with ``state = {"prev_idx": int}`` and ``idx`` a host
    int; ``out``, as in ``make_fft_fleet_step``, receives B5's stores.  Slot
    layout: each slot is ``chunk.reshape(B*C, N)``.  Caller contract: slot
    ``state["prev_idx"]`` still holds the previous chunk when ``step``
    runs (pool depth >= 2; start a stream by zero-filling the initial
    ``prev_idx`` slot from ``fft_fleet_pool_init``).  Magsplit backend
    only (the pool read is the kernel's)."""
    from ..ops.fft_magsplit_kernel import magsplit_projector_pool

    dev = resolve_device(device)
    n_in, n_out = config.fft_size_input, config.fft_size_output
    C = config.channels
    B = n_streams
    backend = _resolve_backend(config, backend, dev)
    if backend != "magsplit":
        raise ValueError(
            f"the pool step is the magsplit kernel's zero-copy form; "
            f"backend {backend!r} fuses its own input reads: use "
            "make_fft_fleet_step"
        )
    _, plan, wh, wcorr = _make_magsplit_op(config, dev)

    def step(state, pool, idx: int, *, out=None):
        if pool.ndim != 3 or tuple(pool.shape[1:]) != (B * C, n_in):
            raise ValueError(
                f"pool must be [P, {B * C}, {n_in}], got {tuple(pool.shape)}"
            )
        out = magsplit_projector_pool(
            pool, state["prev_idx"], idx, wh, wcorr, plan=plan,
            out=_rows(out, B, C, n_out),
        )
        return {"prev_idx": idx}, out.reshape(B, C, n_out)

    return step


def fft_fleet_init(
    config: FftConfig, n_streams: int, backend: str = "auto", device="cuda"
) -> FftState:
    dev = resolve_device(device)
    if _resolve_backend(config, backend, dev) in _PREV_BACKENDS:
        shape = (n_streams, config.channels, config.fft_size_input)
        return {"prev": torch.zeros(shape, dtype=torch.float32, device=dev)}
    shape = (n_streams, config.channels, config.fft_size_output)
    return {"overlap": torch.zeros(shape, dtype=torch.float32, device=dev)}


def fft_fleet_pool_init(prev_idx: int = 0):
    """Initial state for ``make_fft_fleet_step_pool``: the caller
    zero-fills pool slot ``prev_idx`` before the first step (stream start
    = silent previous chunk, as ``fft_fleet_init``)."""
    return {"prev_idx": int(prev_idx)}


def private_carry(value: FftState, leading: tuple, config: FftConfig,
                  device: torch.device) -> FftState:
    """A caller's carry (tensors or numpy arrays) as float32 tensors on
    ``device`` that nothing else references, checked against the shape
    ``leading + [N]`` (``prev``) or ``leading + [M]`` (``overlap``)."""
    widths = {"prev": config.fft_size_input, "overlap": config.fft_size_output}
    if len(value) != 1 or next(iter(value)) not in widths:
        raise ValueError(f"an FFT carry is {{'prev'}} or {{'overlap'}}, got {sorted(value)}")
    (key, arr), = value.items()
    t = torch.as_tensor(arr, dtype=torch.float32).to(device, copy=True)
    shape = leading + (widths[key],)
    if tuple(t.shape) != shape:
        raise ValueError(f"{key} must be {list(shape)}, got {list(t.shape)}")
    return {key: t}


# --------------------------------------------------------------------------
# Stateful wrapper (reference-parity public API)
# --------------------------------------------------------------------------


class ResamplerFft:
    """FFT overlap-add resampler with a fixed chunk-size API
    (reference: src/resampler_fft.rs:43-240).

    Interleaved f32 buffers; exactly one chunk per ``resample()`` call::

        r = ResamplerFft(2, SampleRate.Hz44100, SampleRate.Hz48000)
        input = np.zeros(r.chunk_size_input(), np.float32)
        output = np.zeros(r.chunk_size_output(), np.float32)
        r.resample(input, output)

    The carry lives on ``device`` (the card by default; the CPU only when
    asked).
    """

    def __init__(
        self,
        channels: int,
        sample_rate_input: SampleRate,
        sample_rate_output: SampleRate,
        *,
        backend: str = "auto",
        device="cuda",
    ) -> None:
        sample_rate_input = SampleRate(sample_rate_input)
        sample_rate_output = SampleRate(sample_rate_output)
        cfg = plan_conversion(
            sample_rate_input, sample_rate_output
        ).scale_for_throughput()
        self._config = FftConfig(
            channels=channels,
            fft_size_input=cfg.fft_size_input,
            fft_size_output=cfg.fft_size_output,
        )
        self._input_rate = sample_rate_input
        self._output_rate = sample_rate_output
        self._device = resolve_device(device)
        self._backend = backend
        self._step = make_fft_step(self._config, backend=backend, device=self._device)
        self._state = fft_init(self._config, backend, self._device)

    @property
    def channels(self) -> int:
        return self._config.channels

    @property
    def fft_size_input(self) -> int:
        return self._config.fft_size_input

    @property
    def fft_size_output(self) -> int:
        return self._config.fft_size_output

    def chunk_size_input(self) -> int:
        """Required input size in total f32 values, all channels
        (reference: src/resampler_fft.rs:131-137)."""
        return self._config.fft_size_input * self._config.channels

    def chunk_size_output(self) -> int:
        """Produced output size in total f32 values, all channels
        (reference: src/resampler_fft.rs:139-145)."""
        return self._config.fft_size_output * self._config.channels

    def delay(self) -> int:
        return self._config.delay

    def reset(self) -> None:
        self._state = fft_init(self._config, self._backend, self._device)

    @property
    def state(self) -> FftState:
        return self._state

    @state.setter
    def state(self, value: FftState) -> None:
        # Accept carries saved under another backend resolution (e.g. the
        # magsplit {"prev"} schema restored where matmul's {"overlap"} is
        # production).
        value = private_carry(value, (self._config.channels,), self._config, self._device)
        self._state = convert_fft_state(value, self._config, self._backend, self._device)

    def resample(self, input, output) -> None:
        """Resample exactly one interleaved chunk
        (reference: src/resampler_fft.rs:155-240)."""
        C = self._config.channels
        input = np.asarray(input, dtype=np.float32)
        if input.ndim != 1 or input.size < self.chunk_size_input():
            raise InvalidInputBufferSize(
                f"input must hold at least {self.chunk_size_input()} values"
            )
        if (
            not isinstance(output, np.ndarray)
            or output.ndim != 1
            or output.size < self.chunk_size_output()
        ):
            raise InvalidOutputBufferSize(
                f"output must hold at least {self.chunk_size_output()} values"
            )

        n_in = self._config.fft_size_input
        # deinterleave into a private copy: the carry may keep the chunk
        chunk = torch.tensor(
            np.ascontiguousarray(input[: n_in * C].reshape(n_in, C).T), device=self._device
        )
        self._state, out = self._step(self._state, chunk)
        output[: self.chunk_size_output()] = out.T.reshape(-1).cpu().numpy()

    def process(self, input) -> np.ndarray:
        """Batch helper: pad to whole chunks, resample, truncate to the
        expected length (mirrors the reference CLI batch loop,
        reference: resample/src/main.rs:256-313).  The JAX package scans
        its bulk in multi-chunk dispatches; that only amortises dispatch,
        and this chunk loop carries the same state."""
        input = np.asarray(input, dtype=np.float32)
        ci, co = self.chunk_size_input(), self.chunk_size_output()
        n_chunks = -(-input.size // ci) if input.size else 0
        out = np.zeros(n_chunks * co, np.float32)
        buf_in = np.zeros(ci, np.float32)
        for k in range(n_chunks):
            piece = input[k * ci : (k + 1) * ci]
            buf_in[: piece.size] = piece
            buf_in[piece.size :] = 0.0
            self.resample(buf_in, out[k * co : (k + 1) * co])
        expected = -(-input.size * co // ci)
        return out[:expected]

    def __repr__(self) -> str:
        return (
            f"ResamplerFft(channels={self.channels}, "
            f"{int(self._input_rate)}->{int(self._output_rate)} Hz, "
            f"N={self.fft_size_input}, M={self.fft_size_output})"
        )
