"""Each rank decodes only its own rows of the dataset, on 2 and 4 gloo ranks.

Under a process group a rank decodes only its data index's rows of every
batch, for the card-resident store (``device_data``) as host-fed; under a
spatial ('data', 'model') mesh only model rank 0 of each data index
decodes, and sends each model rank its H-slice over the data index's feed
group. A dataset that counts the rows it yields (``torch_rank_workers.
SpyDataset``) shows, per case:

- a decoding rank's dataset yields ``batch_size / data_size`` rows per
  batch, once per batch of the store or of each host-fed epoch; model
  ranks >= 1 decode none, host-fed and ``device_data`` alike;
- each rank's store is bit for bit the one built the way the port built it
  before: the whole dataset, then the rank's rows and H-slice of each batch;
- an epoch's losses and weights are bit for bit those of the same epoch
  over batches made that old way;
- a rank whose dataset holds another batch count than the others' makes
  every rank raise, naming the counts, before any step's collective.
"""

import numpy as np
import pytest

from littlegan_tpu_torch.config import Config as TConfig
from littlegan_tpu_torch.data.synthetic import SyntheticDataset
from torch_dp_common import run_ranks
from torch_dp_common import one_thread_per_process  # noqa: F401 (an autouse fixture)

ITEMS = 32  # 4 batches of 8

CASES = {
    2: {"dp2-store": dict(device_data=True, steps_per_dispatch=2),
        "sp12-store": dict(device_data=True, steps_per_dispatch=2, mesh=[1, 2]),
        "sp12-host": dict(mesh=[1, 2])},
    4: {"dp4-store": dict(device_data=True, steps_per_dispatch=2),
        "sp22-store": dict(device_data=True, mesh=[2, 2]),
        "sp22-host": dict(mesh=[2, 2])},
}


def _cfg(tiny_cfg, mesh=None, **kw):
    cfg = tiny_cfg.replace(batch_size=8, epoch=1, freq_gen=0, freq_test=0, exp_name="c2", **kw)
    if mesh is not None:
        cfg = cfg.replace(mesh_axes=["data", "model"], mesh_shape=mesh)
    return cfg


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.fixture(scope="module")
def runs(tiny_cfg, tmp_path_factory):
    """world -> (case name -> each rank's result, the mismatch errors)."""
    out = {}
    for world, cases in CASES.items():
        root = tmp_path_factory.mktemp(f"c2_{world}")
        todo = [dict(fn="store_decode", cfg=_fields(_cfg(tiny_cfg, **kw)), root=str(root / name), items=ITEMS)
                for name, kw in cases.items()]
        todo.append(dict(fn="store_mismatch", cfg=_fields(_cfg(tiny_cfg, device_data=True)),
                         root=str(root / "mismatch"), items=ITEMS))
        per_rank = run_ranks("torch_rank_workers:run_cases", world, todo, timeout=240)
        results = list(zip(*per_rank))
        out[world] = (dict(zip(cases, results[:-1])), results[-1])
    return out


def _full_store(tiny_cfg):
    """The whole dataset as an (n_batches, B, ...) store, as one process holds it."""
    cfg = TConfig(**_fields(_cfg(tiny_cfg)))
    images, conds = zip(*SyntheticDataset(cfg, ITEMS).epoch_iterator(0, shuffle=False))
    return np.stack(images), np.stack(conds).astype(np.float32)


def _layout(kw, world):
    mesh = kw.get("mesh") or [world, 1]
    return mesh[0], mesh[1]


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in CASES.items() for n in cases])
def test_each_rank_decodes_only_its_rows(runs, tiny_cfg, world, name):
    kw = CASES[world][name]
    n_data, n_model = _layout(kw, world)
    batches = ITEMS // 8
    for rank, res in enumerate(runs[world][0][name]):
        model_rank = rank % n_model
        assert res["model_rank"] == model_rank
        if model_rank:
            assert res["yielded"] == [], (rank, res["yielded"])
        else:  # the store's batches once, or the epoch's (pairs: every batch)
            assert res["yielded"] == [8 // n_data] * batches, (rank, res["yielded"])


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in CASES.items() for n in cases if "store" in n])
def test_store_equals_the_sliced_whole_store(runs, tiny_cfg, world, name):
    n_data, n_model = _layout(CASES[world][name], world)
    imgs, conds = _full_store(tiny_cfg)
    rows, h = 8 // n_data, tiny_cfg.image_dim // n_model
    for rank, res in enumerate(runs[world][0][name]):
        d, m = divmod(rank, n_model)
        want_imgs = imgs[:, d * rows:(d + 1) * rows, m * h:(m + 1) * h]
        got_imgs, got_conds = res["store"]
        assert got_imgs.dtype == want_imgs.dtype and got_imgs.shape == want_imgs.shape
        np.testing.assert_array_equal(got_imgs, want_imgs)
        np.testing.assert_array_equal(got_conds, conds[:, d * rows:(d + 1) * rows])


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in CASES.items() for n in cases])
def test_epoch_equals_the_old_decode_bit_for_bit(runs, world, name):
    for res in runs[world][0][name]:
        assert res["flat"].keys() == res["ref_flat"].keys()
        for k in res["flat"]:
            np.testing.assert_array_equal(res["flat"][k], res["ref_flat"][k], err_msg=k)
        assert [s for s, _ in res["logged"]] == [s for s, _ in res["ref_logged"]]
        assert res["logged"], "no losses were logged"
        for (_, a), (_, b) in zip(res["logged"], res["ref_logged"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("world", list(CASES))
def test_a_rank_with_another_batch_count_raises_on_every_rank(runs, world):
    errors = runs[world][1]
    assert all(e is not None for e in errors), errors
    assert all("every rank's dataset must yield the global batch count" in e for e in errors)
    assert "rank 1 holds 3 batches" in errors[1]
