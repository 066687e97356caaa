"""The port's pure-Python flax msgpack reader against flax itself, and the
JAX -> PyTorch parameter converter over every packaged ConvTDF checkpoint."""

from pathlib import Path

import numpy as np
import pytest

WEIGHTS = Path(__file__).resolve().parents[1] / "audio_cut_tpu" / "models" / "weights"
CHECKPOINTS = sorted(p.name for p in WEIGHTS.glob("*.msgpack"))


def test_all_packaged_checkpoints_are_covered():
    assert CHECKPOINTS == ["convtdf_bootstrap_v1.msgpack", "convtdf_large_v1.msgpack",
                           "convtdf_tiny_v1.msgpack", "convvad_v1.msgpack"]


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_msgpack_reader_matches_flax_bit_for_bit(name):
    serialization = pytest.importorskip("flax.serialization")
    from audio_cut_tpu_torch.models.flax_msgpack import flatten, read_flax_msgpack

    raw = (WEIGHTS / name).read_bytes()
    got = flatten(read_flax_msgpack(raw))
    want = flatten(serialization.msgpack_restore(raw))
    assert list(got) == list(want)  # same keys in the same order
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w), key
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key


@pytest.mark.parametrize("name, dim_f", [
    ("convtdf_large_v1.msgpack", 2048),
    ("convtdf_bootstrap_v1.msgpack", 2048),
    ("convtdf_tiny_v1.msgpack", 384),
])
def test_converter_maps_every_leaf(name, dim_f):
    import json

    import torch

    from audio_cut_tpu_torch.models.convtdf import ConvTDFNet, convert_convtdf_params
    from audio_cut_tpu_torch.models.flax_msgpack import flatten, read_flax_msgpack

    tree = read_flax_msgpack(WEIGHTS / name)
    sd = convert_convtdf_params(tree)
    leaves = flatten(tree)
    assert len(sd) == len(leaves)
    assert sum(t.numel() for t in sd.values()) == sum(a.size for a in leaves.values())
    meta = json.loads((WEIGHTS / (name + ".json")).read_text())
    net = ConvTDFNet(dim_f, meta["channels"], meta["depth"], meta["tdf_bottleneck"])
    net.load_state_dict(sd, strict=True)
    # every value survives the layout change: the multiset of parameters is equal
    got = np.sort(np.concatenate([t.numpy().ravel() for t in sd.values()]))
    want = np.sort(np.concatenate([np.asarray(a, np.float32).ravel() for a in leaves.values()]))
    np.testing.assert_array_equal(got, want)
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_converter_rejects_unknown_leaves():
    from audio_cut_tpu_torch.models.convtdf import convert_convtdf_params
    from audio_cut_tpu_torch.models.flax_msgpack import read_flax_msgpack

    tree = read_flax_msgpack(WEIGHTS / "convtdf_tiny_v1.msgpack")
    tree["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        convert_convtdf_params(tree)
