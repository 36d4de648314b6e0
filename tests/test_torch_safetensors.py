"""The port's safetensors reader and writer (hop_tpu_torch.utils.
safetensors_io) against the `safetensors` package, both ways: every dtype
the format names (BF16 included), a scalar, an empty tensor, tensors whose
bytes are not aligned to their element size, a file with `__metadata__`,
only the names asked for, and a sharded checkpoint's index read through the
loader. Values are held bitwise, dtype and shape equal."""

import json
import os

import pytest
import torch

from hop_tpu_torch.models import llm_weights
from hop_tpu_torch.utils import safetensors_io as S

st = pytest.importorskip("safetensors.torch")


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(3, 5, generator=g)
    return {
        "f64": torch.randn(2, 3, generator=g, dtype=torch.float64),
        "f32": f,
        "f16": f.half(),
        "bf16": (f * 7).bfloat16(),
        "i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
        "i32": torch.arange(5, dtype=torch.int32) - 2,
        "i16": torch.tensor([-7, 300], dtype=torch.int16),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.arange(7, dtype=torch.uint8),      # 7 bytes: the next is misaligned
        "bool": torch.tensor([[True, False, True]]),
        "bf16_odd": torch.randn(3, generator=g).bfloat16(),
        "f32_odd": torch.randn(2, 2, generator=g),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty(0, 4),
    }


def _header(path):
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return n, json.loads(f.read(n))


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), k


def test_the_package_reads_what_the_port_writes(tmp_path):
    p = str(tmp_path / "port.safetensors")
    want = _tensors()
    S.write(want, p)
    _same(st.load_file(p), want)
    assert (8 + _header(p)[0]) % 8 == 0


def test_the_port_reads_what_the_package_writes(tmp_path):
    p = str(tmp_path / "package.safetensors")
    want = _tensors(1)
    st.save_file(want, p, metadata={"format": "pt"})
    assert _header(p)[1]["__metadata__"] == {"format": "pt"}
    _same(S.read(p), want)


def test_misaligned_tensors_are_copied_aligned(tmp_path):
    """After 7 bytes of u8, the f32 and bf16 tensors start at odd offsets:
    the reader copies them, so every tensor's data is aligned."""
    p = str(tmp_path / "x.safetensors")
    want = {"u8": torch.arange(7, dtype=torch.uint8), "f32": torch.randn(4),
            "bf16": torch.randn(3).bfloat16()}
    S.write(want, p)
    assert _header(p)[1]["f32"]["data_offsets"][0] % 4 != 0
    got = S.read(p)
    _same(got, want)
    for t in got.values():
        assert t.data_ptr() % t.element_size() == 0


def test_only_the_names_asked_for(tmp_path):
    p = str(tmp_path / "x.safetensors")
    want = _tensors(2)
    S.write(want, p)
    got = S.read(p, ["bf16", "i8"])
    _same(got, {k: want[k] for k in ("bf16", "i8")})
    with pytest.raises(KeyError):
        S.read(p, ["nope"])


def test_views_of_the_map_do_not_write_the_file(tmp_path):
    p = str(tmp_path / "x.safetensors")
    S.write({"a": torch.zeros(4)}, p)
    t = S.read(p)["a"]
    t += 1
    assert torch.equal(S.read(p)["a"], torch.zeros(4))


def test_bad_files_raise(tmp_path):
    p = str(tmp_path / "x.safetensors")
    header = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}})
    with open(p, "wb") as f:           # 8 of the 16 bytes
        f.write(len(header).to_bytes(8, "little") + header.encode() + bytes(8))
    with pytest.raises(ValueError, match="bytes"):
        S.read(p)
    header = json.dumps({"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    with open(p, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header.encode() + bytes(2))
    with pytest.raises(ValueError, match="dtype F8_E4M3"):
        S.read(p)
    with pytest.raises(ValueError, match="no safetensors name"):
        S.write({"c": torch.zeros(2, dtype=torch.complex64)}, p)


def test_a_sharded_index_reads_as_the_package_reads_each_shard(tmp_path):
    """`model.safetensors.index.json` and its shards, written by the
    package: the loader's read is every shard's arrays, bitwise."""
    want = {f"layers.{i}.w": torch.randn(8, 8).bfloat16() for i in range(3)}
    want["embed_tokens.weight"] = torch.randn(16, 8)
    shards = {"a.safetensors": ["embed_tokens.weight", "layers.0.w"],
              "b.safetensors": ["layers.1.w", "layers.2.w"]}
    for name, keys in shards.items():
        st.save_file({k: want[k] for k in keys}, str(tmp_path / name))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0},
         "weight_map": {k: n for n, keys in shards.items() for k in keys}}))
    sd, hf_config = llm_weights._read_state_dict(str(tmp_path))
    assert hf_config is None
    _same(sd, want)
    from_package = {}
    for name in shards:
        from_package.update(st.load_file(os.path.join(tmp_path, name)))
    _same(sd, from_package)
