"""The port's TF checkpoint reader (``tensorflow_yolo2_torch/compat/
tf_bundle.py``, numpy alone) against TensorFlow's own reader
(``py_checkpoint_reader``) on checkpoints that TensorFlow writes here
(``tf.raw_ops.SaveV2`` for V2, ``tf.raw_ops.Save`` for V1), and
``chip_smoke.write_tf_bundle``'s V2 output read by TensorFlow.

The checkpoints hold every type the reader covers (float16/32/64,
bfloat16 in V2 only, as V1 cannot save it, int8/16/32/64, uint8, bool),
a 0-d and an empty tensor, a string tensor (skipped by name), and 400
names of ~3 KB in groups of 8 that share 1.5 KB key prefixes: enough
to span several table blocks (TensorFlow's blocks hold 256 KiB). Every
array must be equal bit for bit, with the same names, dtype and shape.
TensorFlow is imported lazily (``pytest.importorskip``).
"""

import os
import shutil

import numpy as np
import pytest

from tensorflow_yolo2_torch.compat import tf_bundle

GROUPS, PER_GROUP, PREFIX_CHARS, SUFFIX_CHARS = 50, 8, 1500, 1500


@pytest.fixture(scope="module")
def tf():
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    return pytest.importorskip("tensorflow")


def _tensors(tf, bfloat16: bool) -> dict:
    rng = np.random.RandomState(0)
    out = {
        "dtypes/float16": rng.normal(0, 3, (3, 5)).astype(np.float16),
        "dtypes/float32": rng.normal(0, 3, (2, 3, 4)).astype(np.float32),
        "dtypes/float64": rng.normal(0, 3, (7,)),
        "dtypes/int8": rng.randint(-128, 128, (3, 3)).astype(np.int8),
        "dtypes/int16": rng.randint(-2**15, 2**15, 5).astype(np.int16),
        "dtypes/int32": rng.randint(-2**31, 2**31, 6).astype(np.int32),
        "dtypes/int64": rng.randint(-2**62, 2**62, 4).astype(np.int64),
        "dtypes/uint8": rng.randint(0, 256, (2, 7)).astype(np.uint8),
        "dtypes/bool": rng.rand(9) > 0.5,
        "scalar": np.float32(3.25),
        "empty": np.zeros((0, 3), np.float32),
        "strings": tf.constant([b"ab", b"c"]),
    }
    if bfloat16:
        out["dtypes/bfloat16"] = tf.cast(
            rng.normal(0, 3, (4, 3)).astype(np.float32), tf.bfloat16)
    for g in range(GROUPS):
        stem = f"net/group_{g:02d}/" + "w" * PREFIX_CHARS
        for i in range(PER_GROUP):
            out[f"{stem}/unit_{i}/" + "k" * SUFFIX_CHARS] = rng.normal(
                0, 1, (i + 1, 2)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def checkpoints(tf, tmp_path_factory):
    root = tmp_path_factory.mktemp("tf_ckpts")
    v2 = _tensors(tf, bfloat16=True)
    written = {"v2": v2}
    tf.raw_ops.SaveV2(prefix=str(root / "v2"), tensor_names=list(v2),
                      shape_and_slices=[""] * len(v2),
                      tensors=list(v2.values()))
    v1 = written["v1"] = _tensors(tf, bfloat16=False)
    tf.raw_ops.Save(filename=str(root / "v1.ckpt"), tensor_names=list(v1),
                    data=list(v1.values()))
    return {"v2": str(root / "v2"), "v1": str(root / "v1.ckpt"),
            "written": {fmt: {k: np.asarray(v) for k, v in d.items()
                              if k != "strings"}
                        for fmt, d in written.items()}}


def tf_read(path: str) -> dict:
    """Every tensor that TensorFlow's reader reads, by name: not the
    string ones, and in V1 not float16 (its V1 reader refuses them)."""
    import tensorflow as tf
    from tensorflow.python.training import py_checkpoint_reader

    reader = py_checkpoint_reader.NewCheckpointReader(path)
    out = {}
    for name, dtype in reader.get_variable_to_dtype_map().items():
        if dtype == tf.string:
            continue
        try:
            out[name] = np.asarray(reader.get_tensor(name))
        except tf.errors.UnimplementedError:
            assert dtype == tf.float16 and not os.path.exists(
                path + ".index"), name
    return out


def tf_names(path: str) -> list:
    from tensorflow.python.training import py_checkpoint_reader

    return sorted(py_checkpoint_reader.NewCheckpointReader(path)
                  .get_variable_to_shape_map())


def assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("fmt", ["v2", "v1"])
def test_reader_matches_tensorflow(checkpoints, fmt):
    path = checkpoints[fmt]
    want = tf_read(path)
    assert "strings" in tf_names(path) and "strings" not in want
    got = tf_bundle.load_tf_checkpoint(path)
    assert_same({k: got[k] for k in want}, want)
    # and every tensor as it was written, float16 in V1 too
    assert_same(got, checkpoints["written"][fmt])
    assert len(got) == GROUPS * PER_GROUP + 11 + (fmt == "v2")
    table = tf_bundle._Table(path + ".index" if fmt == "v2" else path)
    assert sum(1 for _ in table._entries(table.index)) >= 3  # data blocks


def test_crc32c():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283  # the check value
    assert tf_bundle.crc32c(b"") == 0
    rng = np.random.RandomState(2)
    for n in (1, 3, 255, 256, 257, 4096 + 5, 300001):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        reg = 0xFFFFFFFF  # the bitwise definition, byte by byte
        for byte in data[:2000]:
            reg ^= byte
            for _ in range(8):
                reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
        if n <= 2000:
            assert tf_bundle.crc32c(data) == reg ^ 0xFFFFFFFF, n
        # bytes and a uint8 array alike
        assert tf_bundle.crc32c(data) == tf_bundle.crc32c(
            np.frombuffer(data, np.uint8).copy()), n


def _copy(checkpoints, tmp_path, fmt):
    src = checkpoints[fmt]
    if fmt == "v1":
        shutil.copy(src, tmp_path / "c.ckpt")
        return str(tmp_path / "c.ckpt")
    for suffix in (".index", ".data-00000-of-00001"):
        shutil.copy(src + suffix, str(tmp_path / "c") + suffix)
    return str(tmp_path / "c")


def _flip(path: str, offset: int, value: int | None = None) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([value if value is not None else byte ^ 0x40]))


def test_refuses_a_crc_mismatch_of_a_tensor(checkpoints, tmp_path):
    prefix = _copy(checkpoints, tmp_path, "v2")
    _flip(prefix + ".data-00000-of-00001", 3)
    with pytest.raises(ValueError, match="tensor '.*': crc32c .* stored"):
        tf_bundle.load_tf_checkpoint(prefix)


@pytest.mark.parametrize("fmt", ["v2", "v1"])
def test_refuses_a_crc_mismatch_of_a_block(checkpoints, tmp_path, fmt):
    prefix = _copy(checkpoints, tmp_path, fmt)
    _flip(prefix + ".index" if fmt == "v2" else prefix, 20)
    with pytest.raises(ValueError, match="block at 0: crc32c .* stored"):
        tf_bundle.load_tf_checkpoint(prefix)


def test_refuses_a_compressed_block(checkpoints, tmp_path):
    prefix = _copy(checkpoints, tmp_path, "v2")
    index = prefix + ".index"
    table = tf_bundle._Table(index)
    handle = next(table._entries(table.index))[1]
    _, pos = tf_bundle._varint(handle, 0)
    size, _ = tf_bundle._varint(handle, pos)
    _flip(index, size, value=1)  # the first block's trailer: snappy
    with pytest.raises(ValueError, match="compression type 1 .snappy."):
        tf_bundle.load_tf_checkpoint(prefix)


def test_refuses_sliced_tensors(tf, tmp_path):
    part = np.arange(2, dtype=np.float32)
    tf.raw_ops.SaveV2(prefix=str(tmp_path / "p2"), tensor_names=["w"],
                      shape_and_slices=["4 0,2"], tensors=[part])
    with pytest.raises(ValueError, match="tensor 'w' is sliced"):
        tf_bundle.load_tf_checkpoint(str(tmp_path / "p2"))
    tf.raw_ops.SaveSlices(filename=str(tmp_path / "p1.ckpt"),
                          tensor_names=["w"], shapes_and_slices=["4 0,2"],
                          data=[part])
    with pytest.raises(ValueError, match="tensor 'w' is saved in 1 slice"):
        tf_bundle.load_tf_checkpoint(str(tmp_path / "p1.ckpt"))


def test_missing_checkpoint(tmp_path):
    assert not tf_bundle.checkpoint_present(str(tmp_path / "x"))
    assert not tf_bundle.checkpoint_present(None)
    with pytest.raises(FileNotFoundError, match="no TF checkpoint at"):
        tf_bundle.load_tf_checkpoint(str(tmp_path / "x"))


def test_chip_smoke_writer_reads_in_tensorflow(tf, tmp_path):
    """``chip_smoke.write_tf_bundle`` writes what TensorFlow's reader
    reads, bit for bit (and the port's reader too)."""
    import chip_smoke

    rng = np.random.RandomState(5)
    tensors = {
        "darknet19/Variable": rng.normal(0, 1, (3, 3, 3, 8)).astype(
            np.float32),
        "darknet19/Variable_1": rng.normal(0, 1, 8).astype(np.float32),
        "darknet19/batch_normalization/moving_mean": np.zeros(
            8, np.float32),
        "scalar": np.float64(2.5), "empty": np.zeros((0, 4), np.float32),
        "counts": np.arange(5, dtype=np.int64), "mask": rng.rand(3) > 0.5,
        "half": rng.normal(0, 1, 3).astype(np.float16),
    }
    prefix = str(tmp_path / "smoke")
    chip_smoke.write_tf_bundle(prefix, tensors)
    want = {k: np.asarray(v) for k, v in tensors.items()}
    assert_same(tf_read(prefix), want)
    assert_same(tf_bundle.load_tf_checkpoint(prefix), want)
