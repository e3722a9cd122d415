"""The port's reader of motif_tpu's orbax train states
(`motif_tpu_torch.checkpoint.read_orbax_tree`, `ocdbt.py`, `utils/zstd.py`)
against orbax's own raw restore (`ocp.StandardCheckpointer().restore`).

Full width: the Ours params (setting 5, channel 64, 5 + 40 blocks;
12,297,743 parameters) drawn by the port's init and bridged by
`motif_tpu.checkpoint.port_torch_state_dict`, with seeded Adam moments, in
an Adam and an AdamW `TrainState` saved by
`motif_tpu.checkpoint.save_train_state`. Every leaf read must be bit-equal
to orbax's, under the same keys and containers. orbax keeps every key of
such a state in one B+tree leaf (its node limit is 100 MB); the AdamW
state is written with that limit lowered to 64 KiB through orbax's own
writer options, so that its tree has interior nodes, and the reader must
walk them. Large arrays are stored out of line (orbax inlines values up
to 1024 bytes): both kinds are checked in the files read.

Then the types a state can hold (bfloat16, float64 / int64 under x64,
Python scalars, empty values), arrays orbax writes in several chunks,
zarr's partial edge chunks and absent chunks (`fill_value`), the refusals
(an unknown format version, compression or magic, a bad checksum, a root
without a step, a tree that does not match the model, Adam against
AdamW), zstd frames against the `zstandard` package, and a process that
reads a state without importing jax, orbax, tensorstore, zstandard or
motif_tpu.
"""

import json
import os
import pathlib
import shutil
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from _orbax_parity import (assert_same_tree, flat, full_width_params,
                           optax_state, orbax_restore, raw, sha256)
from motif_tpu import checkpoint as jckpt
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch import ocdbt
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.trainer import Trainer, TrainerConfig
from motif_tpu_torch.utils import zstd

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "orbax_state"
N_PARAMS = 12_297_743
NODE_LIMIT = 64 * 1024


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    tree = full_width_params()
    assert sum(a.size for a in jax.tree.leaves(tree)) == N_PARAMS
    return tree


def _save_with_node_limit(monkeypatch, limit):
    """orbax's OCDBT writer options with max_decoded_node_bytes `limit`."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu

    add = tsu.add_ocdbt_write_options

    def small_nodes(spec, *a, **kw):
        add(spec, *a, **kw)
        spec["config"]["max_decoded_node_bytes"] = limit
    monkeypatch.setattr(tsu, "add_ocdbt_write_options", small_nodes)


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_full_width_state_reads_as_orbax_restores_it(params, opt, tmp_path,
                                                     monkeypatch):
    state = optax_state(params, 1e-2 if opt == "adamw" else 0.0)
    with monkeypatch.context() as mp:
        if opt == "adamw":
            _save_with_node_limit(mp, NODE_LIMIT)
        jckpt.save_train_state(str(tmp_path), 7, state, meta={"epoch": 3})
    step_dir = tmp_path / "step_7"
    want = orbax_restore(step_dir)
    got = tckpt.read_orbax_tree(str(tmp_path))      # the root's newest step
    assert isinstance(got["opt_state"], list)
    assert len(got["opt_state"]) == (3 if opt == "adamw" else 2)
    # params, mu and nu; Adam's count, the schedule's count and the step
    assert assert_same_tree(got, want) == 3 * len(jax.tree.leaves(params)) + 3
    store = ocdbt.OcdbtStore(str(step_dir))
    indirect = [k for k, v in store.entries.items() if not isinstance(v,
                                                                     bytes)]
    assert indirect and len(indirect) < len(store.entries)
    assert b"params.encoder.feature_extraction.block.conv1.kernel/0.0.0.0.0" \
        in indirect
    if opt == "adamw":
        assert store.nodes["interior"] > 0 and store.nodes["leaf"] > 1
        assert store.config["max_decoded_node_bytes"] == NODE_LIMIT
    else:
        assert store.nodes == {"leaf": 1, "interior": 0}
    assert store.stats["num_keys"] == len(store.entries)
    assert tckpt.restore_meta(str(tmp_path), 7) == {"epoch": 3}


def test_each_kind_of_leaf_reads_as_orbax_restores_it(tmp_path):
    """bfloat16 (a torch.bfloat16 tensor), float64 and int64 under x64,
    numpy arrays, Python scalars, empty dicts / lists / None, a tuple
    (restored as a list) and nested sequences."""
    rng = np.random.default_rng(3)
    with jax.enable_x64(True):
        tree = {"bf16": jnp.asarray(rng.standard_normal((5, 3)),
                                    jnp.bfloat16),
                "f64": jnp.asarray(rng.standard_normal((2, 2, 3))),
                "i64": jnp.arange(6, dtype=jnp.int64).reshape(2, 3),
                "np32": rng.standard_normal((4,)).astype(np.float32),
                "scalar_i": 7, "scalar_f": 0.25,
                "i32": jnp.asarray(-3, jnp.int32),
                "empty": {}, "none": None, "nil": [],
                "seq": ({"a": jnp.ones((2,), jnp.float32)},
                        [jnp.zeros((1,), jnp.int32), None])}
        jckpt.save_train_state(str(tmp_path), 1, tree)
        want = orbax_restore(tmp_path / "step_1")
    got = tckpt.read_orbax_tree(str(tmp_path / "step_1"))
    assert isinstance(got["bf16"], torch.Tensor) and \
        got["bf16"].dtype == torch.bfloat16
    assert got["f64"].dtype == np.float64 and got["i64"].dtype == np.int64
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], list)
    assert assert_same_tree(got, want) == 7


def test_zarr_chunk_grids_as_orbax_writes_them(tmp_path):
    """Arrays orbax writes in several chunks (`SaveArgs.chunk_byte_size`)
    read back whole, float32 and bfloat16."""
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(2)
    tree = {"a": jnp.asarray(rng.standard_normal((5, 7, 3)), jnp.float32),
            "b": jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)}
    save_args = jax.tree.map(lambda a: ocp.SaveArgs(chunk_byte_size=40),
                             tree)
    with ocp.PyTreeCheckpointer() as c:
        c.save(str(tmp_path / "step_1"), tree, save_args=save_args)
    store = ocdbt.OcdbtStore(str(tmp_path / "step_1"))
    assert len([k for k in store.list() if k.startswith(b"a/")]) > 10
    assert assert_same_tree(tckpt.read_orbax_tree(str(tmp_path)),
                            orbax_restore(tmp_path / "step_1")) == 2


def _memory_store(arrays: dict) -> ocdbt.OcdbtStore:
    """A store of zarr v2 arrays held in memory: {name: (.zarray dict,
    {chunk key: chunk array})}, each chunk zstd-compressed."""
    store = ocdbt.OcdbtStore.__new__(ocdbt.OcdbtStore)
    store.root, store.entries = "memory", {}
    for name, (meta, chunks) in arrays.items():
        store.entries[f"{name}/.zarray".encode()] = json.dumps(meta).encode()
        for key, chunk in chunks.items():
            store.entries[f"{name}/{key}".encode()] = \
                zstandard.ZstdCompressor().compress(chunk.tobytes())
    return store


@pytest.mark.parametrize("dtype", ["<f4", "<i8", "bfloat16"])
def test_zarr_edge_chunks_and_fill_value(dtype):
    """A 5 x 7 array in 2 x 3 chunks (the edge chunks stored whole, as
    zarr v2 pads them), two chunks absent: read as `fill_value`."""
    np_dtype = {"<f4": np.float32, "<i8": np.int64,
                "bfloat16": np.float32}[dtype]
    full = (np.arange(9 * 9).reshape(9, 9) - 40).astype(np_dtype)
    fill = -2
    chunks = {}
    for i in range(3):
        for j in range(3):
            if (i, j) in ((0, 1), (2, 2)):
                continue
            c = full[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            if dtype == "bfloat16":
                c = (c.view(np.uint32) >> 16).astype(np.uint16)
            chunks[f"{i}.{j}"] = np.ascontiguousarray(c)
    meta = {"zarr_format": 2, "shape": [5, 7], "chunks": [2, 3],
            "dtype": dtype, "fill_value": fill, "order": "C",
            "filters": None, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": "."}
    got = ocdbt.read_array(_memory_store({"x": (meta, chunks)}), "x")
    want = full[:5, :7].copy()
    want[0:2, 3:6] = fill
    want[4:5, 6:7] = fill
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _rewrite(path, at, value):
    """Set byte `at` of the file at `path` and its crc32c footer anew."""
    data = bytearray(path.read_bytes())
    data[at] = value
    data[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(data[:-4])))
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("fault", ["version", "compression", "magic",
                                   "checksum", "manifest_kind"])
def test_an_unknown_format_raises_naming_the_file(tmp_path, fault):
    shutil.copytree(FIXTURE, tmp_path / "s")
    manifest = tmp_path / "s" / "step_2" / "manifest.ocdbt"
    if fault == "version":          # the varint after magic and length
        _rewrite(manifest, 12, 1)
    elif fault == "compression":
        _rewrite(manifest, 13, 5)
    elif fault == "magic":
        _rewrite(manifest, 0, 0x0D)
    elif fault == "checksum":
        data = bytearray(manifest.read_bytes())
        data[20] ^= 1
        manifest.write_bytes(bytes(data))
    else:                           # an uncompressed manifest of kind 1
        body = ocdbt.decode_envelope(manifest.read_bytes(),
                                     ocdbt.MANIFEST_MAGIC, "m")
        body = body[:16] + b"\x01" + body[17:]
        data = struct.pack(">I", ocdbt.MANIFEST_MAGIC) + struct.pack(
            "<Q", 12 + 2 + len(body) + 4) + b"\x00\x00" + body
        manifest.write_bytes(data + struct.pack("<I", ocdbt.crc32c(data)))
    with pytest.raises(ocdbt.OcdbtError, match=str(manifest)) as e:
        tckpt.read_orbax_tree(str(tmp_path / "s"))
    assert {"version": "version 1", "compression": "compression 5",
            "magic": "magic", "checksum": "crc32c",
            "manifest_kind": "kind 1"}[fault] in str(e.value)


def test_a_root_without_a_step_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        tckpt.read_orbax_tree(str(tmp_path))
    (tmp_path / "step_3").mkdir()
    with pytest.raises(FileNotFoundError, match="step_3"):
        tckpt.read_orbax_tree(str(tmp_path))


def _small_model():
    torch.manual_seed(0)
    return MoTIF(16, 1, 2)


def _small_state(tmp_path, weight_decay):
    m = _small_model()
    tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
        m.state_dict()))
    jckpt.save_train_state(str(tmp_path), 2, optax_state(
        tree, weight_decay, step=2))
    return tree


def test_a_mismatched_tree_raises_naming_keys(tmp_path):
    tree = _small_model().state_dict()
    tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(tree))
    tree.pop("alpha")
    tree["imnet"]["extra"] = np.zeros((2,), np.float32)
    jckpt.save_train_state(str(tmp_path), 1, {"params": tree})
    with pytest.raises(KeyError) as e:
        tckpt.load_checkpoint(_small_model(), str(tmp_path))
    for name in ("step_1", "alpha", "imnet/extra"):
        assert name in str(e.value)


def _stack_pcd(node):
    """The interim layout of motif_tpu's DeformableConvLSTM: pcd_h and
    pcd_c stacked into one 'pcd_hc' subtree on a leading [h, c] axis."""
    if not isinstance(node, dict):
        return node
    node = dict(node)
    if "pcd_h" in node:
        h, c = node.pop("pcd_h"), node.pop("pcd_c")
        node["pcd_hc"] = jax.tree.map(lambda a, b: np.stack([a, b]), h, c)
    return {k: _stack_pcd(v) for k, v in node.items()}


def test_an_old_pcd_hc_tree_loads_as_motif_tpu_loads_it(tmp_path):
    """A params tree of that interim layout: `load_checkpoint` unstacks it
    (motif_tpu/checkpoint.py:102-115) and loads the model it came from;
    motif_tpu's `load_params` gives the same leaves."""
    want = _small_model()
    tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
        want.state_dict()))
    old = _stack_pcd(tree)
    assert "pcd_hc" in str(jax.tree_util.tree_structure(old))
    jckpt.save_train_state(str(tmp_path), 1, {"params": old})
    torch.manual_seed(9)
    got = MoTIF(16, 1, 2)
    tckpt.load_checkpoint(got, str(tmp_path))
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    loaded = jckpt.load_params(str(tmp_path), jax.tree.map(np.zeros_like,
                                                           tree))
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("saved,trainer", [("adam", "adamw"),
                                           ("adamw", "adam")])
def test_adam_against_adamw_raises(tmp_path, saved, trainer):
    _small_state(tmp_path, 1e-2 if saved == "adamw" else 0.0)
    tr = Trainer(_small_model(), TrainerConfig(
        weight_decay=1e-2 if trainer == "adamw" else 0.0))
    with pytest.raises(ValueError, match="AdamW" if saved == "adamw"
                       else "2 entries"):
        tckpt.restore_train_state(str(tmp_path), 2, tr)


def test_fixture_matches_its_list_and_orbax():
    """tests/fixtures/orbax_state (tools/make_orbax_fixture.py) read anew:
    every leaf's dtype, shape and sha256 as its leaves.json lists them (from
    orbax's restore when it was written), the same out-of-line keys, and
    the same tree as orbax restores today."""
    spec = json.loads((FIXTURE / "leaves.json").read_text())
    step_dir = FIXTURE / spec["step_dir"]
    got = tckpt.read_orbax_tree(str(FIXTURE))
    leaves = flat(got)
    assert [list(p) for p in sorted(leaves)] == [r["path"] for r in
                                                 spec["leaves"]]
    for row in spec["leaves"]:
        leaf = leaves[tuple(row["path"])]
        if row["dtype"] is None:
            assert leaf is None
            continue
        dtype, shape, _ = raw(leaf)
        assert (dtype, list(shape), sha256(leaf)) == \
            (row["dtype"], row["shape"], row["sha256"]), row["path"]
    store = ocdbt.OcdbtStore(str(step_dir))
    assert sorted(k.decode() for k, v in store.entries.items()
                  if not isinstance(v, bytes)) == spec["out_of_line"]
    assert assert_same_tree(got, orbax_restore(step_dir)) == 18


def test_zstd_frames_decode_as_zstandard_writes_them():
    rng = np.random.default_rng(0)
    data = (rng.integers(0, 4, 3 << 20, dtype=np.uint8)).tobytes()
    sized = zstandard.ZstdCompressor(level=1).compress(data)
    unsized = zstandard.ZstdCompressor(
        level=3, write_content_size=False).compress(data)
    cobj = zstandard.ZstdCompressor().compressobj()
    streamed = cobj.compress(data) + cobj.flush()
    for frame in (sized, unsized, streamed):
        assert zstd.decompress(frame) == data
        assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(sized + unsized) == data + data
    for bad in (unsized[:len(unsized) // 2], b"\x00" * 16):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(bad)


def test_reading_imports_no_jax_orbax_tensorstore_or_zstandard(tmp_path):
    """A fresh process reads the fixture and restores a train state of the
    port's Trainer from it: none of jax, orbax, tensorstore, zstandard or
    motif_tpu reaches sys.modules."""
    code = f"""
import sys
from motif_tpu_torch import checkpoint, ocdbt, train, test, demo, flow
tree = checkpoint.read_orbax_tree({str(FIXTURE)!r})
assert tree["step"] == 2 and len(tree["opt_state"]) == 3
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "orbax", "tensorstore", "zstandard",
              "motif_tpu", "flax", "optax"))
print("FORBIDDEN", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_precompute_flows_takes_an_orbax_raft_tree(tmp_path):
    """motif_tpu's tools/precompute_flows.py restores a bare RAFT params
    tree from an orbax directory; the port's `build_raft` loads the same
    directory strictly."""
    from motif_tpu_torch.models.raft import RAFT
    from motif_tpu_torch.precompute_flows import build_raft

    torch.manual_seed(4)
    want = RAFT()
    tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
        want.state_dict()))
    jckpt.save_train_state(str(tmp_path), 1, tree)
    got = build_raft(str(tmp_path / "step_1"), "cpu")
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
