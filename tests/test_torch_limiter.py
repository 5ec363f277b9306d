"""K3's gain walk as redesigned for the card, modelled on the CPU.

``model_walk`` is csrc/limiter.cu's phase 2 in numpy float32 scalars: the
walk tables (dsp/limiter.walk_tables), R[k] = thr / W[k], the tile flags
(a flag-clear tile is all 1 with the envelope settled or idle, else walked
with W = 0), and the m-indexed chain with the next step's gain computed
both ways and selected, as the kernel orders it. It is held bit for bit (gains and the envelope state) to the plain
twin ``_gain_walk`` on the binaural content of the smoke run's binaural
phase, a +4 dB burst across a batch edge, retriggers inside attack and
inside release, and a state taken from the JAX limiter mid-release
through convert.pipe_carry; on each, to the JAX package's ``_gain_step``
run op by op, bit for bit, and scanned under jit, where XLA's fused step
rounds a few products differently (the same triggers, gains within 4 ulp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectors
from iamf_tpu.constants import ChannelLayout
from iamf_tpu.dsp import limiter as jlim
from iamf_tpu_torch import convert
from iamf_tpu_torch.core import pipeline as ppipe
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import limiter

f32 = np.float32
CFG = limiter.LimiterConfig(channels=2)


def model_walk(cfg, env, W):
    """Phase 2 of K3 over window maxima W from env. Returns (gains, env',
    triggers)."""
    tab = limiter.walk_tables(cfg)
    M, A = tab.M, tab.A
    T, C = limiter.padded_tables(cfg)
    thr = f32(cfg.linear_threshold)
    W = np.asarray(W, np.float32)
    with np.errstate(divide="ignore"):
        R = thr / W
    N, TS = len(W), limiter.WALK_TILE
    g0, tsg, teg, tc0 = (f32(v) for v in env)
    idle0 = tc0 == f32(-1.0)
    if idle0:
        teg, m = f32(-1.0), M
    else:
        m = int(np.searchsorted(T[:M + 1], tc0))
        assert T[m] == tc0
    dA, dR = tsg - teg, f32(1.0) - teg
    C1, C2, C3 = C[1], C[2], C[3]

    gains = np.empty(N, np.float32)
    last, triggers = g0, 0
    zeros = np.zeros(TS, np.float32)
    for k0 in range(0, N, TS):
        n = min(TS, N - k0)
        Wt, Rt = W[k0:k0 + n], R[k0:k0 + n]
        if not (Wt > thr).any():  # the flag is clear: no trigger possible
            if m == M:  # settled or idle: a unit tile
                gains[k0:k0 + n] = 1.0
                last = f32(1.0)
                continue
            Wt = Rt = zeros
        att = m < A  # no settled case: coef past M is 1
        g = (tsg if att else teg) + C[m + 1] * (dA if att else dR)
        L = [C[m + 2], C[m + 3]]  # La, Lb: coef[m + 2] loaded 2 steps ahead
        for i in range(n):
            k = k0 + i
            w, r = Wt[i], Rt[i]
            gains[k] = g
            c = C2 if m == 0 else C3 if m == 1 else L[i & 1]
            L[i & 1] = C[m + 4]
            mn = min(m + 1, M)
            att = mn < A
            gN = (tsg if att else teg) + c * (dA if att else dR)
            trig = w * g > thr
            dAt = g - r
            gT = g + C1 * dAt
            if trig:
                tsg, teg, dA, dR, m, g = g, r, dAt, f32(1.0) - r, 0, gT
                triggers += 1
            else:
                m, g = mn, gN
        last = gains[k0 + n - 1]
    idle = idle0 and teg == f32(-1.0)
    env = np.array([last, env[1] if idle else tsg, env[2] if idle else teg,
                    -1.0 if idle else T[m]], np.float32)
    return gains, env, triggers


def twin_trace(cfg, env, W):
    """_gain_walk one sample at a time: the gains and every tc it
    reaches."""
    env = np.asarray(env, np.float32)
    gains, tcs = np.empty(len(W), np.float32), np.empty(len(W), np.float32)
    for k in range(len(W)):
        g, env = limiter._gain_walk(cfg, env, W[k:k + 1])
        gains[k], tcs[k] = g[0], env[3]
    return gains, env, tcs


@functools.lru_cache(maxsize=None)
def _jax_scan(threshold_db):
    jcfg = jlim.LimiterConfig(threshold_db=threshold_db)

    def step(c, p):
        return jlim._gain_step(jcfg, c, p)
    return jax.jit(lambda st, w: jax.lax.scan(step, st, w))


def jax_walk(cfg, env, W):
    """The JAX package's _gain_step scanned over W from env."""
    keys = ("current_gain", "target_start_gain", "target_end_gain",
            "current_tc")
    st = {k: jnp.float32(v) for k, v in zip(keys, env)}
    st, gains = _jax_scan(cfg.threshold_db)(st, jnp.asarray(W, jnp.float32))
    return np.asarray(gains), np.array([st[k] for k in keys], np.float32)


def window_peaks(state, x):
    """W[k] = max of the look-ahead ring at step k, as limit_plain reads it
    (state: this package's limiter state; x [C, N])."""
    peak = state["peak_data"].numpy()
    D = len(peak)
    idx = int(state["entry_index"][0])
    S = np.concatenate([peak[(idx + np.arange(D)) % D],
                        np.abs(np.asarray(x)).max(0)])
    return np.lib.stride_tricks.sliding_window_view(S, D)[:x.shape[1]].max(1)


def one_stream(fn, cfg, state, x, *args):
    """fn (limit_plain or limit_quantize) on one stream: the stream axis
    put on the state and x, and taken off the state and output."""
    state, y = fn(cfg, {k: v[None] for k, v in state.items()}, x[None],
                  *args)
    return {k: v[0] for k, v in state.items()}, y[0]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def check_walk(cfg, env, W):
    """The model against the twin, bit for bit, and the JAX scan. Returns
    (the model's env', its triggers, the twin's tc trace)."""
    gm, em, trig = model_walk(cfg, env, W)
    gt, et, tcs = twin_trace(cfg, env, W)
    gj, ej = jax_walk(cfg, env, W)
    np.testing.assert_array_equal(_bits(gm), _bits(gt))
    np.testing.assert_array_equal(_bits(em), _bits(et))
    # the jitted scan: XLA's fused step rounds a few products differently
    # from the op-by-op order (test_eager_jax_step_is_bit_exact), so the
    # same triggers and the same tc, gains within 4 ulp
    assert np.abs(_bits(gm).astype(np.int64) - _bits(gj)).max() <= 4
    assert np.abs(_bits(em).astype(np.int64) - _bits(ej)).max() <= 4
    assert em[3] == ej[3]
    T = limiter.walk_tables(cfg).T
    assert np.isin(tcs, np.concatenate([[-1.0], T]).astype(np.float32)).all()
    return em, trig, tcs


def test_tables():
    """T strictly increases to the first value >= rel + atk; coef holds
    the curve values the recurrence computes at each step count."""
    tab = limiter.walk_tables(CFG)
    T, coef, M, A = tab.T, tab.coef, tab.M, tab.A
    atk, rel = f32(CFG.attack_sec), f32(CFG.release_sec)
    inc = f32(CFG.inc_tc)
    relatk = rel + atk
    assert (np.diff(T) > 0).all()
    assert T[0] == 0 and T[M - 1] < relatk <= T[M]
    assert A == np.count_nonzero(T < atk) and 0 < A < M
    assert M > 9000  # 0.201 s at 48 kHz
    tc = f32(0.0)
    for m in range(1, M + 1):
        # the recurrence's own step from tc = T[m - 1]
        in_attack = tc < atk
        tc = tc + inc
        assert tc == T[m]
        if in_attack:
            assert m <= A and -coef[m] == limiter._curve_accel(tc / atk)
        else:
            assert m > A and coef[m] == limiter._curve_accel(
                (tc - atk) / rel)
    assert coef[0] == 0
    pad = limiter.padded_tables(CFG)
    P = pad.shape[1]
    assert P % 4 == 0 and P >= M + 5
    assert (pad[0, :M + 1] == T).all() and (pad[0, M:] == T[M]).all()
    assert (pad[1, :M + 1] == coef).all() and (pad[1, M + 1:] == 1).all()


def test_settled_release_step_is_one():
    """With coef 1 the release formula gives exactly the settled gain 1
    for every target end gain a trigger can set (thr / W, W > thr: in
    (0, 1)) and for the idle marker -1, so K3's walk has no settled case."""
    rng = np.random.RandomState(0)
    teg = np.concatenate([
        rng.rand(1_000_000).astype(np.float32),
        np.ldexp(f32(1.0) - rng.rand(10000).astype(np.float32) * f32(2**-10),
                 -rng.randint(0, 126, 10000)).astype(np.float32),
        np.nextafter(f32(1.0), f32(0.0), dtype=np.float32)[None],
        np.float32([2.0**-149, 2.0**-126, 0.5, 0.25, 1e-30, -1.0]),
        f32(CFG.linear_threshold) / (f32(CFG.linear_threshold)
                                     + rng.rand(10000).astype(np.float32)),
    ])
    teg = teg[(teg > 0) & (teg < 1) | (teg == -1)]
    d = f32(1.0) * (f32(1.0) - teg)
    assert ((teg + d) == 1).all()


def test_binaural_content():
    """The smoke run's binaural content (7.1.4 at amp 0.5, headphones
    mode 1, M2B): every limiter batch of the port's CPU decode, from the
    state the pipeline carried in; the model's env' is the state the
    pipeline carries out. Prints the retrigger density."""
    stream, _ = vectors.build_pcm_layout_stream(ChannelLayout.L714,
                                                n_frames=40, amp=0.5, hrm=1)
    calls = []
    real = ppipe.limit_quantize

    def spy(cfg, state, x, bits, frame):  # x [S = 1, C, N]
        calls.append((cfg, {k: v[0].clone() for k, v in state.items()},
                      x[0].clone()))
        return real(cfg, state, x, bits, frame)

    ppipe.limit_quantize = spy
    try:
        BatchedStreamDecoder(stream, binaural=True, batch_frames=16,
                             device="cpu").decode_all()
    finally:
        ppipe.limit_quantize = real
    assert len(calls) >= 3
    n = trig = 0
    for i, (cfg, state, x) in enumerate(calls):
        em, t, _ = check_walk(cfg, state["env"].numpy(),
                              window_peaks(state, x))
        if i + 1 < len(calls):
            np.testing.assert_array_equal(_bits(em),
                                          _bits(calls[i + 1][1]["env"]))
        n += x.shape[1]
        trig += t
    print(f"binaural M2B content: {trig} retriggers over {n} samples, one "
          f"per {n / trig:.2f} samples")
    assert 1.2 < n / trig < 2.5


def _burst(n, lo, hi, seed=3):
    """[2, n] sine bed at 0.4 FS with a +4 dB burst over [lo, hi)."""
    x = vectors.sine_pcm(n, 2, 48000, amp=0.4, seed=seed) / 32768.0
    x[lo:hi] = vectors.sine_pcm(hi - lo, 2, 48000, amp=1.45,
                                seed=seed + 1) / 32768.0
    return x.T.astype(np.float32)


def test_burst_across_batch_edge():
    """Attack at the end of one batch, release into the next, settled
    (gain 1, tc held at T[M]) through the batches after it."""
    N = 8 * 960
    x = _burst(4 * N, N - 600, N + 900)
    tab = limiter.walk_tables(CFG)
    st = limiter.init_state(CFG, "cpu")
    phases = set()
    for b in range(4):
        xb = torch.from_numpy(x[:, b * N:(b + 1) * N])
        env0 = st["env"].numpy()
        em, _, tcs = check_walk(CFG, env0, window_peaks(st, xb))
        st, _ = one_stream(limiter.limit_plain, CFG, st, xb, 960)
        np.testing.assert_array_equal(_bits(em), _bits(st["env"]))
        m = np.searchsorted(tab.T, tcs[tcs >= 0])
        phases |= {"attack" if k < tab.A else "release" if k < tab.M
                   else "settled" for k in m}
        if b == 0:
            assert env0[3] == -1  # idle until the burst
    assert phases == {"attack", "release", "settled"}
    assert st["env"][3] == tab.T[tab.M]


def test_retriggers_inside_attack_and_release():
    """Window maxima with a peak over the threshold, a louder one inside
    its attack and another inside its release, and random peaks."""
    tab = limiter.walk_tables(CFG)
    W = _retrigger_peaks()
    env0 = np.array([1.0, -1.0, -1.0, -1.0], np.float32)
    _, trig, tcs = check_walk(CFG, env0, W)
    before = tcs[np.flatnonzero(tcs == 0) - 1]  # tc before each trigger
    assert (before == -1).any()
    assert ((before > 0) & (before < tab.T[tab.A])).any()      # in attack
    assert ((before >= tab.T[tab.A]) & (before < tab.T[tab.M])).any()
    assert trig > 10


def _retrigger_peaks():
    rng = np.random.RandomState(5)
    W = (0.5 + 0.3 * rng.rand(6000)).astype(np.float32)
    W[100:104] = 1.2
    W[120:125] = 1.6    # attack runs 48 steps from 100
    W[800:803] = 1.9    # release runs to step ~9750 after 120
    W[1500] = 1.0       # below threshold * gain: no trigger
    spikes = rng.randint(2000, 6000, 40)
    W[spikes] = (1.0 + rng.rand(40)).astype(np.float32)
    return W


def test_eager_jax_step_is_bit_exact():
    """_gain_step run op by op (each jnp operation rounded on its own, the
    reference's order) gives the model's gains bit for bit through
    triggers, attack and release."""
    jcfg = jlim.LimiterConfig(channels=2)
    W = _retrigger_peaks()[:400]
    env0 = np.array([1.0, -1.0, -1.0, -1.0], np.float32)
    gm, em, trig = model_walk(CFG, env0, W)
    keys = ("current_gain", "target_start_gain", "target_end_gain",
            "current_tc")
    st = {k: jnp.float32(v) for k, v in zip(keys, env0)}
    gj = np.empty(len(W), np.float32)
    for k, w in enumerate(W):
        st, g = jlim._gain_step(jcfg, st, jnp.float32(w))
        gj[k] = g
    np.testing.assert_array_equal(_bits(gm), _bits(gj))
    np.testing.assert_array_equal(
        _bits(em), _bits(np.array([st[k] for k in keys], np.float32)))
    assert trig >= 2


def test_state_from_jax_mid_release():
    """A limiter state the JAX package carries out mid-release, converted
    with convert.pipe_carry, walks on identically."""
    jcfg = jlim.LimiterConfig(channels=2)
    N = 4800
    x = _burst(3 * N, 1000, 3000, seed=7)
    st_j = jlim.init_state(jcfg)
    st_j, _ = jlim.process_block(jcfg, st_j, jnp.asarray(x[:, :2 * N]))
    st = {k: v[0] for k, v in  # the one stream
          convert.pipe_carry({"pos": 0, "limiter": st_j}, "cpu")[
              "limiter"].items()}
    tab = limiter.walk_tables(CFG)
    tc = st["env"][3].numpy()
    assert tab.T[tab.A] <= tc < tab.T[tab.M]  # mid-release
    xb = torch.from_numpy(x[:, 2 * N:])
    em, _, _ = check_walk(CFG, st["env"].numpy(), window_peaks(st, xb))
    st_j, _ = jlim.process_block(jcfg, st_j, jnp.asarray(x[:, 2 * N:]))
    ej = np.array([st_j[k] for k in ("current_gain", "target_start_gain",
                                     "target_end_gain", "current_tc")],
                  np.float32)
    np.testing.assert_array_equal(_bits(em), _bits(ej))


def test_unreachable_tc_refused():
    """K3 places tc by an exact search in T: convert refuses a state whose
    tc the recurrence cannot reach."""
    tab = limiter.walk_tables(CFG)
    st = jlim.init_state(jlim.LimiterConfig(channels=2))
    for tc in (-1.0, 0.0, tab.T[17], tab.T[tab.M]):
        convert.limiter_state(dict(st, current_tc=np.float32(tc)), "cpu")
    for tc in (tab.T[17] * f32(1.0000001), f32(0.5) * tab.T[1], 0.3):
        with pytest.raises(ValueError, match="reaches"):
            convert.limiter_state(dict(st, current_tc=np.float32(tc)), "cpu")


@pytest.mark.parametrize("true_peak", [False, True])
def test_stream_axis_equals_single_streams(true_peak):
    """limit_quantize on x [3, C, N] with a [3, ...] state (one stream
    engaged, one idle, one entering mid-release) gives each stream what an
    S = 1 call on its slice gives: 0 LSB and an equal state. The twin runs
    the streams one by one; K3 walks each in its own block
    (tests/test_torch_cuda.py holds the card to this)."""
    rng = np.random.RandomState(11)
    C, N = 2, 4 * 960
    cfg = limiter.LimiterConfig(channels=C, true_peak=true_peak)
    mid, _ = one_stream(limiter.limit_plain, cfg,
                        limiter.init_state(cfg, "cpu"),
                        torch.from_numpy(_burst(N, 500, 1500)), 960)
    states = [limiter.init_state(cfg, "cpu"), limiter.init_state(cfg, "cpu"),
              mid]
    x = np.stack([_burst(N, 900, 2500, seed=4),
                  (rng.randn(C, N) * 0.05).astype(np.float32),
                  (rng.randn(C, N) * 0.2).astype(np.float32)])
    x = torch.from_numpy(x)
    stacked = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    st3, pcm3 = limiter.limit_quantize(cfg, stacked, x, 16, 960)
    assert pcm3.shape == (3, N, C)
    envs = []
    for s in range(3):
        st1, pcm1 = one_stream(limiter.limit_quantize, cfg, states[s],
                               x[s], 16, 960)
        assert torch.equal(pcm3[s], pcm1)
        for k in st1:
            assert torch.equal(st3[k][s], st1[k]), (s, k)
        envs.append(float(st1["env"][3]))
    assert envs[1] == -1.0 and envs[0] != -1.0 and envs[2] != -1.0
