"""The port's console entry point (libnyquist_torch.cli) against the JAX
package's, on the CPU: the four cases of tests/test_cli.py on an in-repo
Ogg Opus file (golden case 0 written by tools/opus_stream.py
make_case_file; tests/test_cli.py skips without its reference corpus).

The printed ``len:`` equals the JAX CLI's, ``sum:`` within 1e-4 a sample
(load()'s Opus bound); ``--info`` prints the same line; ``--save`` writes
a WAV within one 16-bit step of the JAX CLI's; ``--check`` fails on a
file outside the oracle set and writes ``opusdec.wav`` as the JAX CLI
does.
"""

import re

import numpy as np
import pytest
import torch

import libnyquist_torch as nqt
import libnyquist_tpu as nq
from libnyquist_torch import cli
from libnyquist_tpu import cli as jcli

from .test_torch_streaming import tool


@pytest.fixture(scope="module")
def opus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "case0.opus"
    path.write_bytes(tool("opus_stream").make_case_file(0))
    return path


def _len_sum(out):
    m = re.search(r"len: (\d+) sum: (-?[\d.]+)", out)
    return int(m.group(1)), float(m.group(2))


def test_cli_decode_prints_len_sum(opus_file, capsys):
    assert cli.main([str(opus_file)], device="cpu") == 0
    out = capsys.readouterr().out
    assert jcli.main([str(opus_file)]) == 0
    ref = capsys.readouterr().out
    n, total = _len_sum(out)
    rn, rtotal = _len_sum(ref)
    assert n == rn > 0
    assert abs(total - rtotal) <= 1e-4 * n
    a = nqt.load(str(opus_file), device="cpu")
    assert f"{a.channel_count}ch 48000Hz" in out
    assert out.splitlines()[1].split("]", 1)[1] == \
        ref.splitlines()[1].split("]", 1)[1]


def test_cli_info_lazy(opus_file, capsys):
    assert cli.main([str(opus_file), "--info"], device="cpu") == 0
    out = capsys.readouterr().out
    assert jcli.main([str(opus_file), "--info"]) == 0
    assert out == capsys.readouterr().out
    assert out.startswith("OggSeekReader: ")


def test_cli_save_wav_roundtrip(opus_file, tmp_path, capsys):
    mine, theirs = tmp_path / "port.wav", tmp_path / "jax.wav"
    assert cli.main([str(opus_file), "--save", str(mine)], device="cpu") == 0
    assert jcli.main([str(opus_file), "--save", str(theirs)]) == 0
    assert f"saved {mine}" in capsys.readouterr().out
    got = nqt.load(str(mine), device="cpu")
    ref = nq.load(str(theirs))
    assert (got.sample_rate, got.sample_count) == (ref.sample_rate,
                                                   ref.sample_count)
    # PCM_16 saves: within one step of each other
    err = np.abs(np.asarray(got.samples) - np.asarray(ref.samples)).max()
    assert err < 2.0 / 32768


def test_cli_check_flags_wrong_oracle(opus_file, tmp_path, monkeypatch,
                                      capsys):
    # the case file is not one of the three oracle files: --check fails
    # and writes the mismatch WAV like the reference app
    monkeypatch.chdir(tmp_path)
    assert cli.main([str(opus_file), "--check"], device="cpu") == 1
    assert "wrong results!" in capsys.readouterr().out
    assert (tmp_path / "opusdec.wav").exists()
    got = nqt.load(str(tmp_path / "opusdec.wav"), device="cpu")
    ref = nqt.load(str(opus_file), device="cpu")
    np.testing.assert_array_equal(got.samples, ref.samples)


def test_cli_runs_on_cuda_unless_told(opus_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(opus_file)])
