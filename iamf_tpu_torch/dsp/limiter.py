"""Look-ahead peak limiter (counterpart of iamf_tpu/dsp/limiter.py;
reference: audio_effect_peak_limiter.c process_block :94-201).

Per sample k: peak = max of the look-ahead peak ring (the last
``delay_size`` channel-max magnitudes); gain = the attack/release
parabolic envelope (compute_target_gain :237-265, curve_accel :267-271),
retriggered by a peak above threshold; output = delayed sample * gain.

One batch of the decode pipeline goes through ``limit_quantize``: on a
CUDA tensor the hand-written kernel K3 (csrc/limiter.cu) runs the limiter
and the quantize/interleave epilogue; on a CPU tensor the plain twin runs
the reference's structure (whole-batch fast path, else per frame: fast
path or the per-sample recurrence). The recurrence's per-sample loop runs
on a host copy, in numpy float32 scalars with the reference's operation
order: a loop of per-sample device launches is exactly what K3 replaces.

K3's gain walk reads the recurrence off tables indexed by the step count
since the last trigger (``walk_tables``): the envelope time tc is -1 or
one of the values T[m] the recurrence reaches, so each coefficient is
computed once, on the host, with the same float32 roundings.

True-peak mode (LimiterConfig.true_peak; the decoder sets it from
IAMF_TRUEPEAK=1, as the JAX decoder does): the magnitudes fed into the peak
ring are a 4x-oversampled inter-sample peak estimate instead of max_c |x|
(``input_peaks``): the repo's own 48-tap Hann-windowed sinc as 4 phases x
12 taps (``truepeak_filters``), with an 11-sample history per channel
carried across batches. On a CUDA tensor the hand-written kernel K9
(csrc/truepeak.cu) meters and K3 reads its peaks; on a CPU tensor the plain
twin ``truepeak_plain`` does. The rest of the limiter is unchanged.

Streams: the batch is x [S, C, N], S streams of one LimiterConfig (the
multi-stream server's bucket, core/serving.py; S = 1 for one decoder), and
every state tensor has the leading stream axis. The peak is a maximum over
one stream's channels, so each stream walks its own envelope: K3 and K9
take the S streams in one launch, the twins run them one by one.
``init_state`` gives one stream's state without the axis.

Frame-serial decoder (api.py): ``Limiter`` carries one stream's state
(S = 1) on its device from call to call, keeps the reference's first-call
padding swallow and quantizes in the same call: K3 (after K9 in true-peak
mode) on a CUDA device, one launch a frame, and the twins on the CPU.

State (a dict of tensors; core/pipeline.py carries it across batches):
  env:         float32 [S, 4] = current_gain, target_start_gain,
               target_end_gain, current_tc (-1 = idle)
  delay_data:  [S, C, D] delay line;  peak_data: [S, D] peak ring
  entry_index: int32 [S, 1], ring slot of the oldest entry
  tp_hist:     [S, C, 11] the meter's last input samples, oldest first
               (true peak only)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.build import F, I, Kernel, P
from .quantize import pad_stride, quantize_interleave

LIMITER_THRESHOLD_DB = -1.0
LIMITER_ATTACK_SEC = 0.001
LIMITER_RELEASE_SEC = 0.200
LIMITER_LOOKAHEAD = 240

WALK_TILE = 1024  # samples per tile of K3's walk (csrc/limiter.cu TS)

TP_PHASES = 4    # 4x oversampling
TP_TAPS = 12     # taps per phase (48-tap prototype)
TP_HIST = TP_TAPS - 1

K3 = Kernel("iamf_k3_limiter",
            [P, I, I, I, P, P, P, P, I, P, F, P, P, I, I, I, I, P, P, P, P,
             P, P])
K9 = Kernel("iamf_k9_truepeak", [P, P, I, I, I, P, P])


@functools.lru_cache(maxsize=None)
def truepeak_filters() -> np.ndarray:
    """[TP_PHASES, TP_TAPS] float32 polyphase interpolation filters (a copy
    of iamf_tpu/dsp/limiter.py's): a 48-tap Hann-windowed sinc at 1/4 band;
    phase j holds taps h[4 i + j], applied to x[n - i], normalized to unit
    DC gain. The reference ships no meter, so these are the repo's own
    coefficients; csrc/truepeak.cu holds them as literals."""
    L = TP_PHASES * TP_TAPS
    n = np.arange(L, dtype=np.float64)
    c = (L - 1) / 2.0
    proto = np.sinc((n - c) / TP_PHASES) * np.hanning(L)
    phases = np.empty((TP_PHASES, TP_TAPS), np.float64)
    for j in range(TP_PHASES):
        phases[j] = proto[j::TP_PHASES]
        phases[j] /= phases[j].sum()
    return phases.astype(np.float32)


def emit_truepeak_c_table() -> str:
    """C initializer of truepeak_filters' table (a copy of
    iamf_tpu/dsp/limiter.py's): a C oracle of the meter compiled from this
    string holds the very constants the port's meter reads."""
    h = truepeak_filters()
    rows = ",\n".join(
        "  {" + ", ".join(f"{v:.9e}f" for v in row) + "}" for row in h)
    return ("static const float TP_PHASES_TAB[%d][%d] = {\n%s\n};\n"
            % (TP_PHASES, TP_TAPS, rows))


@dataclasses.dataclass(frozen=True)
class LimiterConfig:
    threshold_db: float = LIMITER_THRESHOLD_DB
    sample_rate: int = 48000
    channels: int = 2
    attack_sec: float = LIMITER_ATTACK_SEC
    release_sec: float = LIMITER_RELEASE_SEC
    delay_size: int = LIMITER_LOOKAHEAD
    true_peak: bool = False  # USE_TRUEPEAK branch: the 4x meter

    @property
    def linear_threshold(self) -> float:
        return float(10.0 ** (self.threshold_db / 20.0))

    @property
    def inc_tc(self) -> float:
        return 1.0 / self.sample_rate


def init_state(cfg: LimiterConfig, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    state = {
        "env": torch.tensor([1.0, -1.0, -1.0, -1.0], **f32),
        "delay_data": torch.zeros((cfg.channels, cfg.delay_size), **f32),
        "peak_data": torch.zeros((cfg.delay_size,), **f32),
        "entry_index": torch.zeros((1,), dtype=torch.int32, device=device),
    }
    if cfg.true_peak:
        state["tp_hist"] = torch.zeros((cfg.channels, TP_HIST), **f32)
    return state


def truepeak_plain(x, hist):
    """Plain twin of K9: x [S, C, T], hist [S, C, 11] -> (peaks [S, T],
    hist'). win[s, c, t, i] = x[s, c, t - i] (hist[..., -1] the newest
    sample before x); each phase sums its taps in order i = 0..11, as K9
    does; every operation is elementwise or a maximum, so a stream's peaks
    do not depend on the others."""
    K9.note_plain(x)
    S, C, T = x.shape
    h = torch.from_numpy(truepeak_filters()).to(x.device)
    xc = torch.cat([hist, x], dim=2)
    acc = x.new_zeros((S, C, TP_PHASES, T))
    for i in range(TP_TAPS):
        acc = acc + h[None, None, :, i, None] * xc[:, :, None, TP_HIST - i:
                                                   TP_HIST - i + T]
    return torch.amax(acc.abs(), dim=(1, 2)), xc[..., -TP_HIST:]


def truepeak_cuda(x, hist):
    """K9 on the card: x [S, C, T] float32, hist [S, C, 11] -> (peaks
    [S, T], hist'), the S streams in one launch."""
    S, C, T = x.shape
    if (x.dtype != torch.float32 or hist.dtype != torch.float32
            or tuple(hist.shape) != (S, C, TP_HIST) or T < 1):
        raise ValueError(f"K9 takes float32 x [S, C, T >= 1] and hist "
                         f"[S, C, {TP_HIST}]; got {x.dtype} {list(x.shape)}, "
                         f"{hist.dtype} {list(hist.shape)}")
    x, hist = x.contiguous(), hist.contiguous()
    if x.data_ptr() % 16:  # K9 stages aligned rows with float4 loads
        x = x.clone()
    peaks = torch.empty((S, T), dtype=torch.float32, device=x.device)
    hist_out = torch.empty((S, C, TP_HIST), dtype=torch.float32,
                           device=x.device)
    K9(x, hist, S, C, T, peaks, hist_out)
    return peaks, hist_out


def input_peaks(cfg: LimiterConfig, state: dict, x):
    """Per-sample magnitudes feeding the peak ring (process_block
    :150-166) of one stream: max_c |x| in sample-peak mode, the true-peak
    meter's in true-peak mode, whose history moves forward. x: [C, T] ->
    (peaks [T], state'). The twin's route (limit_plain); on the card
    limit_quantize_cuda runs K9 itself."""
    if not cfg.true_peak:
        return torch.amax(torch.abs(x), dim=0), state
    peaks, hist = truepeak_plain(x[None], state["tp_hist"][None])
    return peaks[0], dict(state, tp_hist=hist[0])


def _curve_accel(v):
    one = np.float32(1.0)
    if v > one:
        return one
    if v < np.float32(0.0):
        return np.float32(0.0)
    d = v - one
    return one - d * d


@dataclasses.dataclass(frozen=True)
class WalkTables:
    """The envelope's reachable times and per-step coefficients.

    T[0] = 0, T[m+1] = fl(T[m] + inc) up to T[M], the first value
    >= fl(rel + atk): tc is -1 (idle) or T[m], m steps after the last
    trigger, held at T[M] once settled. The step from count m-1 to m is an
    attack step when T[m-1] < atk (m <= A), a release step when
    T[m-1] < rel + atk (A < m <= M). coef[m] is -curve_accel(T[m] / atk)
    for attack steps and curve_accel((T[m] - atk) / rel) for release steps
    (coef[0] = 0, unused): the gain after m < M steps is then
    fl(tsg + fl(coef[m+1] * fl(tsg - teg))) while m < A, else
    fl(teg + fl(coef[m+1] * fl(1 - teg))), and 1 at m = M."""

    T: np.ndarray     # float32 [M + 1]
    coef: np.ndarray  # float32 [M + 1]
    M: int
    A: int


@functools.lru_cache(maxsize=None)
def _walk_tables(atk: float, rel: float, inc: float) -> WalkTables:
    f = np.float32
    atk, rel, inc = f(atk), f(rel), f(inc)
    relatk = rel + atk
    t = [f(0.0)]
    while t[-1] < relatk:
        t.append(t[-1] + inc)
    T = np.array(t, np.float32)
    M = len(T) - 1
    A = int(np.count_nonzero(T < atk))
    attack = np.arange(M) < A  # steps 1..M
    v = np.where(attack, T[1:] / atk, (T[1:] - atk) / rel)
    d = v - f(1.0)
    c = np.where(v > f(1.0), f(1.0),
                 np.where(v < f(0.0), f(0.0), f(1.0) - d * d))
    coef = np.zeros(M + 1, np.float32)
    coef[1:] = np.where(attack, -c, c)
    for a in (T, coef):
        a.setflags(write=False)
    return WalkTables(T=T, coef=coef, M=M, A=A)


def walk_tables(cfg: LimiterConfig) -> WalkTables:
    """K3's walk tables for cfg's attack, release and sample rate (built
    once; numpy float32 rounds each operation to nearest as the kernel's
    __fadd_rn / __fdiv_rn do)."""
    return _walk_tables(cfg.attack_sec, cfg.release_sec, cfg.inc_tc)


def padded_tables(cfg: LimiterConfig) -> np.ndarray:
    """[T; coef] as K3's walk reads them: [2, P] float32, P >= M + 5 a
    multiple of 4 (the kernel copies them whole with 16-byte bulk copies).
    Past M, T holds T[M] and coef holds 1: the release formula at count M,
    fl(teg + fl(1 * fl(1 - teg))), is exactly 1 for every teg the
    recurrence sets (0 < teg < 1, or -1 while idle), so the walk needs no
    test for a settled envelope, and its loads ahead need no clamp."""
    tab = walk_tables(cfg)
    pad = np.ones((2, -(-(tab.M + 5) // 4) * 4), np.float32)
    pad[0] = tab.T[-1]
    pad[0, :tab.M + 1] = tab.T
    pad[1, :tab.M + 1] = tab.coef
    return pad


_DEVICE_TABLES: dict = {}


def _device_tables(cfg: LimiterConfig, device):
    """padded_tables on `device`, built once per (tables, device)."""
    key = (cfg.attack_sec, cfg.release_sec, cfg.inc_tc, str(device))
    if key not in _DEVICE_TABLES:
        tab = walk_tables(cfg)
        pad = torch.from_numpy(padded_tables(cfg)).to(device)
        _DEVICE_TABLES[key] = (pad[0], pad[1], tab.M, tab.A, pad.shape[1])
    return _DEVICE_TABLES[key]


def check_reachable_tc(cfg: LimiterConfig, tc: float) -> None:
    """Raise unless tc is -1 or a time T[m] the recurrence reaches: K3
    finds m by an exact search in T."""
    tc = np.float32(tc)
    T = walk_tables(cfg).T
    if tc != np.float32(-1.0) and not np.any(T == tc):
        raise ValueError(
            f"limiter envelope time {float(tc)!r} is neither -1 nor a value "
            f"the recurrence reaches from a trigger (T[m], m <= "
            f"{len(T) - 1})")


def _gain_walk(cfg: LimiterConfig, env: np.ndarray, window_peaks):
    """_gain_step over a run of samples in numpy float32 scalars, in the
    reference's operation order. window_peaks[k] = max of the ring at step
    k. Returns (gains float32 [K], env')."""
    f = np.float32
    atk, rel = f(cfg.attack_sec), f(cfg.release_sec)
    inc, thr = f(cfg.inc_tc), f(cfg.linear_threshold)
    relatk = rel + atk
    g, tsg, teg, tc = (f(v) for v in env)
    gains = np.empty(len(window_peaks), np.float32)
    for k, peak in enumerate(window_peaks):
        active = tc != f(-1.0)
        in_attack = active and tc < atk
        in_release = active and tc < relatk
        tcn = tc + inc if (in_attack or in_release) else tc
        if in_attack:
            g = tsg - _curve_accel(tcn / atk) * (tsg - teg)
        elif in_release:
            g = teg + _curve_accel((tcn - atk) / rel) * (f(1.0) - teg)
        else:
            g = f(1.0)
        if peak * g > thr:
            tsg, teg, tc = g, thr / peak, f(0.0)
        else:
            tc = tcn
        gains[k] = g
    return gains, np.array([g, tsg, teg, tc], np.float32)


def _advance(cfg: LimiterConfig, state: dict, x, peaks_in, gains=None,
             env=None):
    """Push x [C, N] through the delay line and peaks_in through the ring;
    the delayed output is multiplied by `gains` (None: gain 1, the idle
    envelope's fast path, fast_pass)."""
    D = cfg.delay_size
    N = x.shape[1]
    dev = x.device
    idx = int(state["entry_index"][0])
    order = (idx + torch.arange(D, device=dev)) % D
    seq = torch.cat([state["delay_data"][:, order], x], dim=1)
    y = seq[:, :N]
    if gains is not None:
        y = y * torch.from_numpy(gains).to(dev)
    peaks_seq = torch.cat([state["peak_data"][order], peaks_in])
    new_idx = (idx + N) % D
    inv = (torch.arange(D, device=dev) - new_idx) % D
    new_state = dict(
        state,
        delay_data=seq[:, N:N + D][:, inv],
        peak_data=peaks_seq[N:N + D][inv],
        entry_index=torch.tensor([new_idx], dtype=torch.int32, device=dev),
    )
    if env is not None:
        new_state["env"] = torch.from_numpy(env).to(dev)
    return new_state, y


def fast_pass(cfg: LimiterConfig, state: dict, x, peaks_in):
    """Below-threshold idle path: pure delay-line passthrough (gain 1)."""
    return _advance(cfg, state, x, peaks_in)


def _can_fast(cfg: LimiterConfig, state: dict, peaks_in) -> bool:
    thr = np.float32(cfg.linear_threshold)
    return (float(state["env"][3]) == -1.0
            and np.float32(state["peak_data"].max()) <= thr
            and np.float32(peaks_in.max()) <= thr)


def _scan(cfg: LimiterConfig, state: dict, x, peaks_in):
    """The per-sample recurrence over one block (reference slow path)."""
    D = cfg.delay_size
    N = x.shape[1]
    idx = int(state["entry_index"][0])
    ring = state["peak_data"].cpu().numpy()
    S = np.concatenate([ring[(idx + np.arange(D)) % D],
                        peaks_in.cpu().numpy()])
    window = np.lib.stride_tricks.sliding_window_view(S, D)[:N].max(axis=1)
    gains, env = _gain_walk(cfg, state["env"].cpu().numpy(), window)
    return _advance(cfg, state, x, peaks_in, gains, env)


def limit_plain(cfg: LimiterConfig, state: dict, x, frame: int):
    """Plain twin of the limiter: the reference's fast/slow structure over
    x [S, C, N] (N a multiple of `frame`), stream by stream. Returns
    (state', limited [S, C, N])."""
    K3.note_plain(x)
    outs = [_limit_stream(cfg, {k: v[s] for k, v in state.items()}, x[s],
                          frame) for s in range(x.shape[0])]
    return ({k: torch.stack([st[k] for st, _ in outs]) for k in state},
            torch.stack([y for _, y in outs]))


def _limit_stream(cfg: LimiterConfig, state: dict, x, frame: int):
    """limit_plain on one stream: x [C, N], state without the axis."""
    peaks_in, state = input_peaks(cfg, state, x)
    if _can_fast(cfg, state, peaks_in):
        return fast_pass(cfg, state, x, peaks_in)
    outs = []
    for f0 in range(0, x.shape[1], frame):
        xf, pf = x[:, f0:f0 + frame], peaks_in[f0:f0 + frame]
        step = fast_pass if _can_fast(cfg, state, pf) else _scan
        state, y = step(cfg, state, xf, pf)
        outs.append(y)
    return state, torch.cat(outs, dim=1)


def k3_scratch(N: int, D: int) -> int:
    """Scratch floats K3 takes a stream (csrc/limiter.cu stream_scratch):
    W, R and gains (NP = ntiles * WALK_TILE each), the peak sequence
    (D + N), tile flags and unit marks (ntiles each), rounded up to 16
    bytes."""
    ntiles = -(-N // WALK_TILE)
    return -(-(3 * ntiles * WALK_TILE + D + N + 2 * ntiles) // 4) * 4


def limit_quantize_cuda(cfg: LimiterConfig, state: dict, x, bits: int):
    """K3 on the card: x [S, C, N] -> (state', pcm [S, N, C] int), the S
    streams in one launch, one gain walk a stream. In true-peak mode K9
    meters x first and K3 reads its peaks."""
    S, C, N = x.shape
    D = cfg.delay_size
    if C != cfg.channels or x.dtype != torch.float32 or N < 1:
        raise ValueError(f"K3 takes float32 [S, {cfg.channels}, N >= 1], "
                         f"got {x.dtype} {list(x.shape)}")
    if bits not in (16, 24, 32):
        raise ValueError(f"bits {bits}")
    shapes = {"env": (S, 4), "delay_data": (S, C, D), "peak_data": (S, D),
              "entry_index": (S, 1)}
    if any(tuple(state[k].shape) != s for k, s in shapes.items()):
        raise ValueError(f"K3 limiter state shapes: want {shapes}, got "
                         f"{ {k: tuple(state[k].shape) for k in shapes} }")
    x = x.contiguous()
    peaks, tp = None, {}
    if cfg.true_peak:
        # the meter's peaks replace K3's max_c |x| (csrc/limiter.cu
        # seq_peaks)
        peaks, tp["tp_hist"] = truepeak_cuda(x, state["tp_hist"])
    state = {k: state[k].contiguous() for k in shapes}
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    tab_t, tab_c, M, A, mp = _device_tables(cfg, dev)
    scratch = torch.empty((S * k3_scratch(N, D),), **f32)
    out = torch.empty((S, N, C),
                      dtype=torch.int16 if bits == 16 else torch.int32,
                      device=dev)
    new = {k: torch.empty_like(v) for k, v in state.items()}
    new.update(tp)
    K3(x, S, C, N, peaks, state["delay_data"], state["peak_data"],
       state["entry_index"], D, state["env"], cfg.linear_threshold,
       tab_t, tab_c, M, A, mp, bits, scratch, out, new["delay_data"],
       new["peak_data"], new["entry_index"], new["env"])
    return new, out


def limit_quantize(cfg: LimiterConfig, state: dict, x, bits: int,
                   frame: int):
    """Limiter + quantize/interleave for one batch of S streams: x [S, C, N]
    float32 -> (state', pcm [S, N, C] int16/int32). CUDA tensors run K3;
    CPU tensors run the plain twin (limit_plain, then
    quantize_interleave)."""
    if x.is_cuda:
        return limit_quantize_cuda(cfg, state, x, bits)
    state, y = limit_plain(cfg, state, x, frame)
    return state, quantize_interleave(y, bits)


class Limiter:
    """The frame-serial limiter (counterpart of iamf_tpu/dsp/limiter.py's
    Limiter): one stream's state with the stream axis ([1, ...]) kept on
    `device`, the first-call swallow of the delay_size padding samples
    (audio_effect_peak_limiter.c:185-201), and the output quantized in the
    same call, since the decoder quantizes right after the limiter."""

    def __init__(self, cfg: LimiterConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self.state = {k: v[None] for k, v in
                      init_state(self.cfg, self.device).items()}
        self.padsize = self.cfg.delay_size
        self.inited = False

    @property
    def delay(self) -> int:
        """audio_effect_peak_limiter_get_delay: delaySize - padsize."""
        return self.cfg.delay_size - self.padsize

    def process(self, x, bits: int, stride: int = 0):
        """x: [C, T] float32 on the device -> pcm [T', stride or C] int16 /
        int32 on it: limit_quantize over the frame (K3 on the card, one
        launch; the twins on the CPU), the first call's padding rows
        dropped. T = 0 launches nothing."""
        C, T = x.shape
        if T:
            self.state, y = limit_quantize(self.cfg, self.state, x[None],
                                           bits, T)
            y = y[0]
        else:
            y = torch.empty((0, C), device=x.device,
                            dtype=torch.int16 if bits == 16 else torch.int32)
        if not self.inited:
            if self.padsize >= T:
                self.padsize -= T
                return pad_stride(y[:0], stride)
            y = y[self.padsize:]
            self.padsize = 0
            self.inited = True
        return pad_stride(y, stride)
