"""The port's atomic writes (``stencil_tpu_torch/utils/artifact.py``): a
write that fails leaves the old file whole and no temp file behind, and
JSON and text round-trip."""

import json
import os

import pytest

from stencil_tpu_torch.utils import artifact


def test_json_round_trips(tmp_path):
    path = str(tmp_path / "sub" / "doc.json")  # the directory is made
    doc = {"b": [1, 2.5, None], "a": {"nested": "text"}, "ok": True}
    assert artifact.atomic_write_json(path, doc) == path
    with open(path) as f:
        text = f.read()
    assert json.loads(text) == doc and text.endswith("\n")
    assert text.index('"a"') < text.index('"b"')  # sorted keys
    assert os.listdir(tmp_path / "sub") == ["doc.json"]


def test_text_and_binary_writes(tmp_path):
    path = str(tmp_path / "plan.txt")
    artifact.atomic_write_text(path, "one\ntwo\n")
    with open(path) as f:
        assert f.read() == "one\ntwo\n"
    with artifact.atomic_write(path, "wb") as f:
        f.write(b"\x00\x01")
    with open(path, "rb") as f:
        assert f.read() == b"\x00\x01"
    assert os.listdir(tmp_path) == ["plan.txt"]


def test_failed_write_keeps_the_old_file_and_no_temp(tmp_path):
    path = str(tmp_path / "chip_smoke.json")
    artifact.atomic_write_json(path, {"run": 1})
    with pytest.raises(RuntimeError, match="midway"):
        with artifact.atomic_write(path) as f:
            f.write('{"run": 2, "half')
            raise RuntimeError("midway")
    with open(path) as f:
        assert json.load(f) == {"run": 1}
    assert os.listdir(tmp_path) == ["chip_smoke.json"]
    # an object json cannot encode fails inside the write alike
    with pytest.raises(TypeError):
        artifact.atomic_write_json(path, {"run": object()})
    with open(path) as f:
        assert json.load(f) == {"run": 1}
    assert os.listdir(tmp_path) == ["chip_smoke.json"]


def test_refuses_append_and_syncs_a_directory(tmp_path):
    with pytest.raises(ValueError, match="whole files"):
        with artifact.atomic_write(str(tmp_path / "x"), "a"):
            pass
    assert os.listdir(tmp_path) == []
    artifact.fsync_dir(str(tmp_path))
    artifact.fsync_dir(str(tmp_path / "missing"))  # a no-op, never raises
