"""The port's LMDB file codec and legacy-pyarrow codec
(hop_tpu_torch.data.lmdbfile, .arrow_legacy) against hop_tpu's, each way,
on the CPU.

LMDB environments written by either package read back equal in the other
(and the files are byte-equal: the port's writer is a copy), for the
empty, single-entry, overflow and branch-level cases. The port's decoder
reads hop_tpu's pyarrow-made payloads for every union tag and both header
variants, and IPC streams in both framings and both metadata versions
(pyarrow writes those here, from outside the port); hop_tpu's decoder
reads the port's payloads. Every decoded value equals the object: the
same Python types, ndarrays by `np.array_equal` and the same dtype. A
fresh process in which pyarrow cannot be imported still round-trips a
video dict through the port's codec.
"""

import io
import os
import struct
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

from hop_tpu.data import arrow_legacy as jal
from hop_tpu.data import lmdbfile as jlmdb

from hop_tpu_torch.data import arrow_legacy as tal
from hop_tpu_torch.data import lmdbfile as tlmdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# lmdbfile
# ---------------------------------------------------------------------------

def _lmdb_items(case):
    if case == "empty":
        return {}
    if case == "single":
        return {b"k": b"v"}
    if case == "overflow":                  # one value over many pages
        return {b"k": b"v" * 100000}
    rng = np.random.default_rng(0)          # "branch": leaves under a branch page
    return {b"%010d" % i: rng.integers(0, 256, size=60000 if i % 7 == 0 else
                                       int(rng.integers(1, 800)), dtype=np.uint8).tobytes()
            for i in range(300)}


LMDB_CASES = ["empty", "single", "overflow", "branch"]


@pytest.mark.parametrize("case", LMDB_CASES)
@pytest.mark.parametrize("writer", ["port", "hop_tpu"])
def test_lmdb_reads_the_other_packages_writes(tmp_path, writer, case):
    items = _lmdb_items(case)
    d = str(tmp_path / "env")
    (tlmdb if writer == "port" else jlmdb).write_lmdb(d, items)
    with tlmdb.LmdbReader(d) as port:
        ref = jlmdb.LmdbReader(d)
        got = list(port.items())
        assert got == list(ref.items()) == sorted(items.items())
        assert len(port) == len(ref) == len(items)
        assert port.stat() == ref.stat()
        if case == "branch":
            assert port.stat()["depth"] == 2
            key = b"%010d" % 7                  # an overflow value
            assert port.get(key) == ref.get(key) == items[key]
        assert port.get(b"absent") is None


@pytest.mark.parametrize("case", LMDB_CASES)
def test_lmdb_files_are_byte_equal(tmp_path, case):
    items = _lmdb_items(case)
    a = tlmdb.write_lmdb(str(tmp_path / "port"), items)
    b = jlmdb.write_lmdb(str(tmp_path / "ref"), items)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# arrow_legacy
# ---------------------------------------------------------------------------

def _video(rng):
    """One value of the reference's source LMDB (data_preprocessor.py:46-80)."""
    return {"vid": "abc123", "clips": [{
        "skeletons_3d": rng.standard_normal((30, 10, 3)),
        "audio_raw": rng.standard_normal(1600).astype(np.float32),
        "audio_feat": rng.standard_normal((128, 40)).astype(np.float16),
        "words": [["hello", 0.1, 0.4], ["world", 0.5, 0.9], ["naïve", 1.0, 1.25]],
        "start_frame_no": 0, "end_frame_no": 300,
        "start_time": 0.0, "end_time": 12.0}]}


def _objects():
    rng = np.random.default_rng(1)
    return {
        "video": _video(rng),
        "cache_sample": [[["w", 0.0, 1.0], ["x", 1.0, 2.0]],
                         rng.standard_normal((42, 10, 3)).astype(np.float32),
                         rng.standard_normal((42, 27)).astype(np.float32),
                         rng.standard_normal(44800).astype(np.float32),
                         rng.standard_normal((128, 88)).astype(np.float32),
                         {"vid": "v", "start_frame_no": 3, "end_frame_no": 45,
                          "start_time": 0.12, "end_time": 2.92,
                          "is_correct_motion": True, "filtering_message": "PASS"}],
        "scalars": [True, False, 3, -2 ** 40, 2.5, np.float32(1.5), "s", "", b"xyz", b""],
        "containers": [("a", 1), {1, 2}, [], (), {}, {"k": [np.arange(5)]},
                       [[1, [2, [3]]], {"d": {"e": {"f": "g"}}}]],
        "ndarrays": [np.arange(7, dtype=np.int8), np.arange(6, dtype=np.uint16).reshape(2, 3),
                     np.arange(4, dtype=np.int32), np.arange(3, dtype=np.int64),
                     np.linspace(0, 1, 5).astype(np.float16),
                     rng.standard_normal((2, 3, 4)).astype(np.float32),
                     rng.standard_normal((5, 2)), np.zeros((0, 3)),
                     np.arange(12.0).reshape(3, 4)[:, ::2]],
        "empty_list": [],
        "empty_dict": {},
        "string": "only a string",
    }


OBJECTS = _objects()


def _expected(obj):
    """What decoding gives back: a float32 scalar as a float (its union
    child is "float"), an ndarray C-contiguous and at least 1-d."""
    if isinstance(obj, np.float32):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return np.ascontiguousarray(obj)
    if isinstance(obj, dict):
        return {k: _expected(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_expected(v) for v in obj)
    return obj


def assert_same(got, want, where="obj"):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
        return
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def _four_count(buf: bytes) -> bytes:
    """The 0.15+ header (a sparse-tensor count after n_tensors) in front of
    the same stream: both variants end at byte 16."""
    nt, nnd, nb = struct.unpack_from("<iii", buf, 0)
    return struct.pack("<iiii", nt, 0, nnd, nb) + buf[16:]


@pytest.mark.parametrize("header", ["three_counts", "four_counts"])
@pytest.mark.parametrize("name", list(OBJECTS))
def test_port_decodes_hop_tpu_payloads(name, header):
    buf = jal.serialize(OBJECTS[name])
    if header == "four_counts":
        buf = _four_count(buf)
    got = tal.deserialize(buf)
    assert_same(got, _expected(OBJECTS[name]))
    assert_same(got, jal.deserialize(buf))


@pytest.mark.parametrize("name", list(OBJECTS))
def test_hop_tpu_decodes_port_payloads(name):
    buf = tal.serialize(OBJECTS[name])
    assert_same(jal.deserialize(buf), _expected(OBJECTS[name]))
    assert_same(tal.deserialize(buf), _expected(OBJECTS[name]))
    assert_same(jal.deserialize(_four_count(buf)), _expected(OBJECTS[name]))


def _pyarrow_payload(obj, version, legacy: bool) -> bytes:
    """hop_tpu's encoding of `obj` with the IPC stream in the given
    framing and metadata version, the tensors in the 0.15+ framing: what
    pyarrow itself writes, from outside the port."""
    ndarrays = []
    builder = jal._SeqBuilder(ndarrays)
    builder.append(obj)
    batch = pa.record_batch([builder.finish()], names=["list"])
    sink = pa.BufferOutputStream()
    options = ipc.IpcWriteOptions(use_legacy_format=legacy, metadata_version=version)
    with ipc.new_stream(sink, batch.schema, options=options) as writer:
        writer.write_batch(batch)
    out = io.BytesIO()
    out.write(struct.pack("<iii", 0, len(ndarrays), 0) + bytes(4))
    out.write(sink.getvalue().to_pybytes())
    for arr in ndarrays:
        out.write(bytes(-out.tell() % 64))
        tensor = pa.BufferOutputStream()
        ipc.write_tensor(pa.Tensor.from_numpy(arr), tensor)
        out.write(tensor.getvalue().to_pybytes())
    return out.getvalue()


@pytest.mark.parametrize("framing", ["int32_length", "continuation"])
@pytest.mark.parametrize("version", ["V4", "V5"])
def test_port_decodes_both_framings_and_metadata_versions(version, framing):
    """V4 unions carry a validity bitmap before their type ids, V5 unions
    none: the buffers are counted by the message's metadata version."""
    obj = OBJECTS["video"]
    buf = _pyarrow_payload(obj, getattr(ipc.MetadataVersion, version),
                           legacy=framing == "int32_length")
    assert_same(tal.deserialize(buf), _expected(obj))


def test_port_payload_layout():
    """The port writes the 0.14 header, the stream in the int32-length
    framing (its end marker 4 zero bytes), each tensor on a 64-byte
    boundary in the continuation framing."""
    arr = np.arange(6, dtype=np.float32)
    buf = tal.serialize({"a": arr})
    assert struct.unpack_from("<iiii", buf, 0) == (0, 1, 0, 0)
    schema_len = struct.unpack_from("<i", buf, 16)[0]
    assert schema_len > 0 and (4 + schema_len) % 8 == 0
    tensor_at = buf.index(struct.pack("<I", 0xFFFFFFFF))
    assert tensor_at % 64 == 0 and buf[tensor_at - 4: tensor_at] == bytes(4)
    body_at = len(buf) - arr.nbytes          # 24 bytes: no padding after it
    assert body_at % 64 == 0 and buf[body_at:] == arr.tobytes()


@pytest.mark.parametrize("bad", ["garbage", "truncated"])
def test_port_rejects_a_broken_payload(bad):
    buf = tal.serialize(OBJECTS["video"])
    buf = (struct.pack("<iiii", 0, 1, 0, 0) + bytes(range(200)) if bad == "garbage"
           else buf[: len(buf) // 2])
    with pytest.raises(ValueError, match="cannot decode legacy-arrow payload"):
        tal.deserialize(buf)


def test_unsupported_values_are_refused():
    for obj in (None, {"a": None}, object(), np.array([True, False])):
        with pytest.raises(TypeError):
            tal.serialize(obj)


NO_PYARROW = r"""
import sys
sys.modules["pyarrow"] = None           # any import of pyarrow now fails
import numpy as np
from hop_tpu_torch.data import arrow_legacy
video = {"vid": "v", "clips": [{"skeletons_3d": np.ones((5, 10, 3)),
         "audio_raw": np.arange(8, dtype=np.float32), "audio_feat":
         np.zeros((128, 2), np.float16), "words": [["a", 0.0, 0.5]],
         "start_frame_no": 0, "end_frame_no": 5, "start_time": 0.0, "end_time": 1.0}]}
out = arrow_legacy.deserialize(arrow_legacy.serialize(video))
c, d = video["clips"][0], out["clips"][0]
assert out["vid"] == "v" and c["words"] == d["words"]
for k in ("skeletons_3d", "audio_raw", "audio_feat"):
    assert d[k].dtype == c[k].dtype and np.array_equal(d[k], c[k]), k
ref = arrow_legacy.deserialize(open(sys.argv[1], "rb").read())
assert np.array_equal(ref["clips"][0]["audio_feat"], c["audio_feat"])
assert ref["clips"][0]["words"] == c["words"]
print("ROUND TRIP OK")
"""


def test_round_trip_without_pyarrow(tmp_path):
    video = {"vid": "v", "clips": [{"skeletons_3d": np.ones((5, 10, 3)),
             "audio_raw": np.arange(8, dtype=np.float32),
             "audio_feat": np.zeros((128, 2), np.float16), "words": [["a", 0.0, 0.5]],
             "start_frame_no": 0, "end_frame_no": 5, "start_time": 0.0, "end_time": 1.0}]}
    path = tmp_path / "ref.arrow"
    path.write_bytes(jal.serialize(video))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", NO_PYARROW, str(path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ROUND TRIP OK" in proc.stdout
