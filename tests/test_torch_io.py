"""The port's containers, codec registry, loader and signatures against the
JAX package.

AIFF, W64 and CAF are copies of the JAX package's pure-numpy codecs: for
every subtype in the JAX table the port must write identical bytes and
read JAX-written files to identical arrays.  ``process()`` and ``load()``
must take their parameters in the JAX package's order.
"""

import inspect

import numpy as np
import pytest

import matchering_tpu as mj
import matchering_tpu_torch as mt
from matchering_tpu.io import codecs as jcodecs
from matchering_tpu.io import loader as jloader
from matchering_tpu_torch import utils
from matchering_tpu_torch.io import codecs as tcodecs

CONTAINERS = ("AIFF", "W64", "CAF")
CASES = [(ext, subtype) for ext in CONTAINERS for subtype in jcodecs._WRITE_FORMATS[ext]]


def _array(seed):
    # within full scale, so every encoding round-trips without clipping
    return np.random.RandomState(seed).uniform(-0.99, 0.99, (1001, 2))


@pytest.mark.parametrize("ext,subtype", CASES)
def test_writer_bytes_and_reader_match_jax(tmp_path, ext, subtype):
    x = _array(len(subtype))
    jax_path = str(tmp_path / f"jax.{ext.lower()}")
    port_path = str(tmp_path / f"port.{ext.lower()}")
    jcodecs.write(jax_path, x, 48000, subtype)
    tcodecs.write(port_path, x, 48000, subtype)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    want, want_rate = jcodecs.read(jax_path)
    got, got_rate = tcodecs.read(jax_path)
    assert got_rate == want_rate == 48000
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_write_table_is_jax_table_without_unported_codecs():
    for fmt in ("WAV", "AIFF", "AIF", "W64", "CAF"):
        assert tcodecs._WRITE_FORMATS[fmt] == jcodecs._WRITE_FORMATS[fmt]
    assert set(tcodecs._WRITE_FORMATS) == {"WAV", "AIFF", "AIF", "W64", "CAF"}


@pytest.mark.parametrize("name", ["o.wav", "o.aiff", "o.aif", "o.w64", "o.caf"])
def test_result_accepts_ported_containers(name):
    assert mt.pcm24(name).subtype == "PCM_24"


@pytest.mark.parametrize("name,subtype", [
    ("o.flac", "PCM_16"), ("o.mp3", "MPEG_LAYER_III"), ("o.aiff", "DOUBLE"), ("o.xyz", "PCM_16"),
])
def test_result_refuses_unported_formats(name, subtype):
    with pytest.raises(TypeError):
        mt.Result(name, subtype)


def test_load_reads_aiff_as_float(tmp_path):
    x = _array(3)
    path = str(tmp_path / "t.aiff")
    jcodecs.write(path, x, 44100, "PCM_24")
    audio, rate = mt.load(path, "target", str(tmp_path))
    want, _ = mj.load(path, "target", str(tmp_path))
    assert rate == 44100
    np.testing.assert_array_equal(audio, want)


def test_load_third_positional_is_temp_folder(tmp_path):
    """``load(f, "target", folder)`` returns floats, as in the JAX package;
    the third positional parameter used to be ``raw_int``."""
    path = str(tmp_path / "t.wav")
    mt.io.wav.write(path, _array(4), 44100, "PCM_16")
    audio, _ = mt.load(path, "target", str(tmp_path))
    want, _ = mj.load(path, "target", str(tmp_path))
    assert audio.dtype == np.float64
    np.testing.assert_array_equal(audio, want)
    raw, _ = mt.load(path, "target", str(tmp_path), True)
    assert raw.dtype == np.int16


@pytest.mark.parametrize("content", [b"FORM\x00\x00\x00\x10AIFFCOMM", b"caff" + bytes(20)],
                         ids=["truncated-aiff", "truncated-caf"])
def test_broken_container_raises_coded_error(tmp_path, content):
    (tmp_path / "r.bin").write_bytes(content)
    with pytest.raises(mt.ModuleError) as error:
        mt.load(str(tmp_path / "r.bin"), "reference")
    assert error.value.code == mt.Code.ERROR_REFERENCE_LOADING


def _positional(fn):
    return [
        p.name for p in inspect.signature(fn).parameters.values()
        if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
    ]


def test_process_signature_is_jax_order():
    assert _positional(mt.process) == _positional(mj.process)
    assert _positional(mt.process)[4:] == ["preview_target", "preview_result"]
    device = inspect.signature(mt.process).parameters["device"]
    assert device.kind == inspect.Parameter.KEYWORD_ONLY


def test_load_signature_is_jax_order():
    assert _positional(mt.load) == _positional(jloader.load)


def test_temp_folder_helpers_match_jax(tmp_path):
    from matchering_tpu import utils as jutils

    results = [mt.pcm16(str(tmp_path / "a" / "o.wav"))]
    assert utils.get_temp_folder(results) == jutils.get_temp_folder(results)
    assert len(utils.random_str()) == len(jutils.random_str()) == 16
    name = utils.random_file(prefix="temp")
    assert name.startswith("temp-") and name.endswith(".wav") and len(name) == 25
