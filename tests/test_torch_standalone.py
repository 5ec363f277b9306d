"""The port's own copies of the JAX package's host modules against their
originals, with the same inputs.

iamf_tpu_torch carries copies of constants, the OBU parser (obu/), the
database (core/database.py), the render tables (dsp/render.py), the host
half of the downmix (dsp/downmix.py), the codec registry and the PCM, FLAC,
Opus and AAC host decoders (codecs/), the muxer (tools/builder.py) and the
stream builders of tests/vectors.py that the smoke run uses
(tools/streams.py), so that it imports nothing of iamf_tpu. Each must give
what its original gives: equal parsed objects, databases, matrices,
decodes and spectra, byte-identical streams and table files.

Objects of the two packages are different classes, so they are compared
through ``plain``: class name and fields, recursively; an enum by its class
name and value.
"""

import collections
import dataclasses
import enum
import filecmp
import os

import numpy as np
import pytest

import vectors
from iamf_tpu import constants as jc
from iamf_tpu.codecs import base as jbase
from iamf_tpu.codecs.aac import decoder as jaac
from iamf_tpu.codecs.flac import decoder as jflac
from iamf_tpu.codecs.opus import decoder as jopus
from iamf_tpu.core import database as jdb
from iamf_tpu.core.batch_decoder import BatchedStreamDecoder as JaxDecoder
from iamf_tpu.dsp import downmix as jdmx
from iamf_tpu.dsp import render as jrdr
from iamf_tpu.obu import parser as jparser
from iamf_tpu.tools import builder as jbuilder
from iamf_tpu_torch import constants as pc
from iamf_tpu_torch.codecs import base as pbase
from iamf_tpu_torch.codecs.aac import decoder as paac
from iamf_tpu_torch.codecs.flac import decoder as pflac
from iamf_tpu_torch.codecs.opus import decoder as popus
from iamf_tpu_torch.core import database as pdb
from iamf_tpu_torch.core.batch_decoder import BatchedStreamDecoder
from iamf_tpu_torch.dsp import downmix as pdmx
from iamf_tpu_torch.dsp import render as prdr
from iamf_tpu_torch.obu import parser as pparser
from iamf_tpu_torch.tools import builder as pbuilder
from iamf_tpu_torch.tools import streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "iamf_tpu", "data", "sample_opus_714.iamf")
L = jc.ChannelLayout


def plain(v):
    """A structural form of v that compares equal across the two packages."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                {f.name: plain(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, collections.deque)):
        return [plain(x) for x in v]
    if isinstance(v, memoryview):
        return bytes(v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if type(v).__module__.startswith("iamf_tpu"):
        return (type(v).__name__, {k: plain(x) for k, x in vars(v).items()})
    return v


def _gains(n, step):
    return [{"animation": jc.AnimationType.LINEAR, "start": -step * (i % 4),
             "end": -step * ((i + 1) % 4)} for i in range(n)]


STREAMS = {
    "opus_sample": lambda: open(SAMPLE, "rb").read(),
    # demix parameter blocks, animated element and output mix gains
    "pcm714_param_blocks": lambda: vectors.build_pcm_layout_stream(
        L.L714, n_frames=5, demix_modes=[0, 1, 2],
        mix_gain_segments=_gains(5, 256), out_gain_segments=_gains(5, 128))[0],
    # two layers with recon gain blocks
    "pcm_scalable_recon": lambda: vectors.build_scalable_pcm_stream(
        n_frames=5, demix_modes=[0, 1, 2, 1],
        recon_gains=[(200, 180), (255, 255), (120, 90)])[0],
    "ambisonics_foa_mono": lambda: vectors.build_ambisonics_pcm_stream(
        order=1, n_frames=4)[0],
    "ambisonics_soa_projection": lambda: vectors.build_ambisonics_pcm_stream(
        order=2, n_frames=4, projection=True)[0],
    "two_elements": lambda: vectors.build_two_element_stream(n_frames=4)[0],
}


def _parse_all(parser, database, data):
    """Every OBU of `data` split and parsed with one package's parser,
    descriptors added to that package's Database, parameter blocks parsed
    against their definitions (as core/timeline.py does)."""
    db = database.Database()
    out = [plain(parser.split_records(data))]
    for obu in parser.iter_obus(data):
        out.append(plain(obu))
        t = obu.type
        if t == 31:
            sh = parser.parse_sequence_header(obu)
            db.add_sequence_header(sh)
            out.append(plain(sh))
        elif t == 0:
            cc = parser.parse_codec_config(obu)
            db.add_codec_config(cc)
            out.append(plain(cc))
        elif t == 1:
            el = parser.parse_audio_element(obu)
            db.add_element(el)
            out.append(plain(el))
        elif t == 2:
            mp = parser.parse_mix_presentation(obu)
            db.add_mix_presentation(mp)
            out.append(plain(mp))
        elif t == 3:
            pid = parser.peek_parameter_block_id(obu)
            pi = db.parameters.get(pid)
            if pi is None:
                continue
            elem = db.element_by_parameter(pid)
            nb_layers = rg = 0
            if elem is not None and elem.channels_config is not None:
                nb_layers = elem.channels_config.nb_layers
                for i, layer in enumerate(elem.channels_config.layers):
                    rg |= int(bool(layer.recon_gain_flag)) << i
            block = parser.parse_parameter_block(obu, pi.base, nb_layers, rg)
            db.add_parameter_block(block, obu.redundant)
            out.append(plain(block))
        elif 5 <= t <= 23:
            out.append(plain(parser.parse_audio_frame(obu)))
    out.append(plain(db))
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parsers_and_databases_match(name):
    """Split records, OBUs, every parsed object and the database they
    build, from both packages' parsers."""
    data = STREAMS[name]()
    off = jparser.find_sequence_header(data)
    assert off == pparser.find_sequence_header(data) >= 0
    want = _parse_all(jparser, jdb, data[off:])
    got = _parse_all(pparser, pdb, data[off:])
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g == w


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoder_databases_match(name):
    """The database each package's BatchedStreamDecoder builds (its parser
    and database, then the timeline replay over them)."""
    data = STREAMS[name]()
    ss = 9 if name.startswith(("opus", "pcm714")) else 1
    jd = JaxDecoder(data, sound_system=ss, batch_frames=4)
    pd = BatchedStreamDecoder(data, sound_system=ss, batch_frames=4,
                              device="cpu")
    assert plain(pd.db) == plain(jd.db)
    assert plain(pd.mix_presentation) == plain(jd.mix_presentation)


def test_constants_match():
    names = [n for n in vars(jc) if not n.startswith("_")
             and not callable(getattr(jc, n))]
    assert len(names) > 20
    for n in names:
        assert plain(getattr(pc, n)) == plain(getattr(jc, n)), n
    for n in ("db_to_linear", "q78_to_db", "q08_to_float", "get_w"):
        for v in (-1024, -3, 0, 5, 255):
            try:
                want = getattr(jc, n)(v)
            except Exception as e:  # noqa: BLE001 - the same refusal
                with pytest.raises(type(e)):
                    getattr(pc, n)(v)
                continue
            assert getattr(pc, n)(v) == want, (n, v)


def test_render_and_downmix_matrices_match():
    """Every M2M and H2M matrix and every downmix matrix of a layout pair
    the port decodes, and the downmix mode/w state machine."""
    out_ids = sorted(set(jrdr.BS2051_IDS.values()) | {jrdr.BINAURAL_ID})
    n = 0
    for tv in (False, True):
        for in_id in jrdr.LAYER_IDS.values():
            for out_id in out_ids:
                try:
                    want = jrdr.m2m_matrix(in_id, out_id, tv)
                except KeyError:
                    with pytest.raises(KeyError):
                        prdr.m2m_matrix(in_id, out_id, tv)
                    continue
                assert np.array_equal(prdr.m2m_matrix(in_id, out_id, tv),
                                      want)
                n += 1
        for order in (1, 2, 3):
            for out_id in out_ids:
                try:
                    want = jrdr.h2m_matrix(order, out_id, tv)
                except KeyError:
                    continue
                got = prdr.h2m_matrix(order, out_id, tv)
                assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
                nout = want[1]
                assert np.array_equal(
                    prdr.h2m_full_matrix(order, out_id, nout, tv),
                    jrdr.h2m_full_matrix(order, out_id, nout, tv))
                n += 1
    assert n > 100
    layouts = [x for x in L if x != L.BINAURAL]
    pairs = 0
    for a in layouts:
        for b in layouts:
            ok = jdmx.can_downmix(a, b)
            assert pdmx.can_downmix(pc.ChannelLayout(a),
                                    pc.ChannelLayout(b)) == ok
            if not ok:
                continue
            for mode in filter(jc.valid_demix_mode, range(8)):
                for w in range(11):
                    assert np.array_equal(
                        pdmx.downmix_matrix(a, b, mode, w),
                        jdmx.downmix_matrix(a, b, mode, w))
            sj, sp = jdmx.DownmixerState(a, b), pdmx.DownmixerState(a, b)
            for mode, w in ((1, -1), (2, -1), (3, 4), (1, -1), (3, -1),
                            (0, 2), (2, 10), (1, -1)):
                sj.set_mode_weight(mode, w)
                sp.set_mode_weight(mode, w)
                assert (sp.mode, sp.w_idx) == (sj.mode, sj.w_idx)
                if sj.mode >= 0:
                    assert np.array_equal(sp.matrix(), sj.matrix())
            pairs += 1
    assert pairs > 10


def test_registries_match():
    assert [int(c) for c in pbase.available_codecs()] == [
        int(c) for c in jbase.available_codecs()]
    assert {c.__module__.split(".")[0] for c in pbase._REGISTRY.values()} \
        == {"iamf_tpu_torch"}


def test_pcm_decodes_match():
    data = vectors.build_pcm_layout_stream(L.L714, n_frames=6)[0]
    jd = JaxDecoder(data, sound_system=9, batch_frames=4)
    pd = BatchedStreamDecoder(data, sound_system=9, batch_frames=4,
                              device="cpu")
    je, pe = jd.elems[0], pd.elems[0]
    assert type(pe.codec).__module__ == "iamf_tpu_torch.codecs.pcm"
    pkts = [jd.frames_per_substream[s] for s in je.substream_ids]
    xj, sj = je.codec.decode_batch_raw(pkts, 960)
    xp, sp = pe.codec.decode_batch_raw(pkts, 960)
    assert xp.dtype == xj.dtype and np.array_equal(xp, xj) and sp == sj
    assert np.array_equal(pe.codec.decode([p[2] for p in pkts]),
                          je.codec.decode([p[2] for p in pkts]))


def test_flac_decodes_match():
    """A stereo and a mono FLAC substream (hand-built VERBATIM frames: the
    repo cannot encode FLAC offline) through both packages' FLACDecoder."""
    T = 960
    src = vectors.sine_pcm(3 * T, 3, amp=0.6, seed=4)
    pkts = [[streams.flac_frame(src[f * T:(f + 1) * T, 0:2], f)
             for f in range(3)],
            [streams.flac_frame(src[f * T:(f + 1) * T, 2:3], f)
             for f in range(3)]]
    conf = streams.flac_conf(T, 2)
    assert plain(pflac.parse_streaminfo(conf)) == plain(
        jflac.parse_streaminfo(conf))
    dj = jflac.FLACDecoder(conf, 2, 1, T)
    dp = pflac.FLACDecoder(conf, 2, 1, T)
    xj, sj = dj.decode_batch_raw(pkts, T)
    xp, sp = dp.decode_batch_raw(pkts, T)
    assert np.array_equal(xp, xj) and sp == sj
    assert np.array_equal(xj, src.reshape(3, T, 3).transpose(0, 2, 1))
    assert np.array_equal(dp.decode([p[1] for p in pkts]),
                          dj.decode([p[1] for p in pkts]))


def test_aac_decodes_match():
    """A stereo and a mono AAC-LC substream (hand-built raw data blocks:
    the repo cannot encode AAC offline) through both packages'
    AACDecoder: PCM frame by frame, the concealment of a lost packet, and
    batched spectra."""
    tab = streams.aac_tables()
    rng = np.random.RandomState(9)
    frames = [[streams.aac_block(rng, tab, 2), streams.aac_block(rng, tab, 1)]
              for _ in range(4)]
    # AudioSpecificConfig: AAC-LC (2), 48 kHz (index 3), 2 channels
    conf = vectors.aac_decoder_config(streams.AAC_ASC)
    dj, dp = (m.AACDecoder(conf, 2, 1, 1024) for m in (jaac, paac))
    for f in frames + [[None, frames[0][1]]]:
        want = dj.decode(f)
        assert want.shape == (3, 1024)
        assert np.array_equal(dp.decode(f), want)
        if f[0] is not None:  # decoded, not concealed
            assert 0.01 < np.abs(want).max() <= 1.0
    dj, dp = (m.AACDecoder(conf, 2, 1, 1024) for m in (jaac, paac))
    want = dj.decode_spectrum_batch(frames)
    got = dp.decode_spectrum_batch(frames)
    assert want["spec"].shape == (4, 3, 1024) and want["spec"].any()
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_opus_spectra_match():
    """The sample's Opus substreams entropy-decoded by each package's
    OpusDecoder: the port's decode_spectrum_batch on its own decoder
    against the JAX package's method, over two batches (the codec states
    chain)."""
    jd = JaxDecoder(open(SAMPLE, "rb").read(), sound_system=9, batch_frames=8)
    je = jd.elems[0]
    pkts = [jd.frames_per_substream[s] for s in je.substream_ids]
    conf = je.codec.decoder_conf
    dj = jopus.OpusDecoder(conf, je.codec.streams, je.codec.coupled_streams,
                           960)
    dp = popus.OpusDecoder(conf, je.codec.streams, je.codec.coupled_streams,
                           960)
    for b0 in (0, 8):
        frames = [[p[k] for p in pkts] for k in range(b0, b0 + 8)]
        want = dj.decode_spectrum_batch(frames, n=960, k=1)
        got = popus.decode_spectrum_batch(dp, frames)
        assert np.array_equal(got["buf"][..., :960], want["buf"][..., :960])
        for k in ("transient", "t_old", "t_cur", "t_new", "g_old", "g_cur",
                  "g_new"):
            assert np.array_equal(got[k], want[k]), k
    assert dp.classify_packets(pkts, 960) == dj.classify_packets(pkts, 960)


STREAM_ARGS = {
    "sine_pcm": [((960, 3), dict(amp=0.7, seed=5)),
                 ((500, 12, 44100), dict(bits=24))],
    "build_pcm_layout_stream": [
        ((L.L714,), dict(n_frames=3, amp=0.5, hrm=1)),
        ((L.L510,), dict(n_frames=2, rate=44100, demix_modes=[1, 2],
                         mix_gain_segments=_gains(2, 256))),
        ((L.STEREO,), dict(n_frames=2, sample_size=24,
                           out_gain_segments=_gains(2, 64))),
    ],
    "build_pcm_51_stream": [((), dict(n_frames=3, hrm=1)),
                            ((), dict(n_frames=2, rate=44100))],
    "build_ambisonics_pcm_stream": [
        ((), dict(order=1, n_frames=2, target_layouts=(0,), hrm=1)),
        ((), dict(order=3, n_frames=2, projection=True))],
    "build_two_element_stream": [((), dict(n_frames=2, gain2_q78=-(3 << 8),
                                           hrm=1))],
    "build_scalable_pcm_stream": [
        ((), dict(n_frames=3, demix_modes=[0, 1, 2], amp=0.3)),
        ((), dict(n_frames=2, recon_gains=[(200, 180)], hrm=1,
                  layer2_output_gain=(0b100000, -256)))],
    "aac_decoder_config": [((bytes([0x11, 0x90]),), {}),
                           ((bytes([0x11, 0x88]),), dict(avg_bitrate=64000))],
}


@pytest.mark.parametrize("fn", sorted(STREAM_ARGS))
def test_stream_builders_byte_identical(fn):
    for args, kw in STREAM_ARGS[fn]:
        got, want = getattr(streams, fn)(*args, **kw), getattr(
            vectors, fn)(*args, **kw)
        if isinstance(want, tuple):
            assert got[0] == want[0]
            for a, b in zip(got[1:], want[1:]):
                assert np.array_equal(a, b)
        else:
            assert np.array_equal(got, want)


def test_builder_copy_matches():
    """The muxer's descriptor writers give the same bytes."""
    assert pbuilder.sequence_header_obu() == jbuilder.sequence_header_obu()
    conf = pbuilder.pcm_decoder_conf(24, 44100)
    assert conf == jbuilder.pcm_decoder_conf(24, 44100)
    assert pbuilder.codec_config_obu(1, b"ipcm", 960, 0, conf) == \
        jbuilder.codec_config_obu(1, b"ipcm", 960, 0, conf)


@pytest.mark.parametrize("path", [
    ("iamf_tpu/dsp/data/render_tables.npz",
     "iamf_tpu_torch/data/render_tables.npz"),
    ("iamf_tpu/codecs/opus/data/opus_tables.npz",
     "iamf_tpu_torch/data/opus_tables.npz"),
])
def test_table_files_byte_identical(path):
    a, b = (os.path.join(ROOT, p) for p in path)
    assert filecmp.cmp(a, b, shallow=False)
