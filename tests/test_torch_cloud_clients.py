"""The port's network clients (cloud/pc.py, cloud/ee.py, cloud/blob.py)
and its calibration copy (cloud/calibration.py) against the JAX
package's, with no network.

The STAC getters run against canned Planetary Computer search responses
(``tests/fixtures/stac_items.json``) served by a fake pystac-client whose
query evaluation mirrors the STAC API's ``query`` extension, and the EE
builders against a recording fake ``ee`` module: ``FakeCatalog`` and
``EENode`` are copied from tests/test_cloud_fixtures.py. Both packages'
clients must send the same searches, return the same items and build the
same expression graphs. The array helpers and the calibration (``equalize_rf``
with the same seed included) must be exactly equal."""

import datetime as dt
import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch

from satellite_computervision_tpu.cloud import blob as jblob
from satellite_computervision_tpu.cloud import calibration as jcal
from satellite_computervision_tpu.cloud import ee as jee
from satellite_computervision_tpu.cloud import pc as jpc
from satellite_computervision_tpu_torch import cloud as tcloud
from satellite_computervision_tpu_torch.cloud import blob as tblob
from satellite_computervision_tpu_torch.cloud import calibration as tcal
from satellite_computervision_tpu_torch.cloud import ee as tee
from satellite_computervision_tpu_torch.cloud import pc as tpc
from test_torch_deeplab import two_torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "stac_items.json")
with open(FIXTURES) as f:
    CANNED = json.load(f)
BBOX = (-76.7, 38.5, -76.5, 38.7)


# ---------------------------------------------------------------------------
# fake pystac-client / planetary-computer (as tests/test_cloud_fixtures.py)
# ---------------------------------------------------------------------------
class FakeItem:
    def __init__(self, d):
        self.id = d["id"]
        self.properties = d["properties"]
        self.datetime = dt.datetime.fromisoformat(
            d["properties"]["datetime"].replace("Z", "+00:00"))


def _matches(props, query):
    """The STAC API query extension's semantics for the ops the clients
    use (lt / eq)."""
    for field, ops in (query or {}).items():
        val = props.get(field)
        for op, ref in ops.items():
            if op == "lt":
                if not (val is not None and val < ref):
                    return False
            elif op == "eq":
                if val != ref:
                    return False
            else:
                raise AssertionError(f"unsupported query op {op!r}")
    return True


class FakeSearch:
    def __init__(self, items):
        self._items = items

    def items(self):
        return list(self._items)


class FakeCatalog:
    def __init__(self, record):
        self.record = record

    def search(self, collections, bbox=None, datetime=None, query=None, **kw):
        self.record["search"] = {"collections": collections, "bbox": bbox,
                                 "datetime": datetime, "query": query}
        items = [FakeItem(d) for d in CANNED.get(collections[0], [])]
        return FakeSearch([i for i in items if _matches(i.properties, query)])


@pytest.fixture()
def fake_stac(monkeypatch):
    """Both packages' pc modules wired to their own fake catalog; returns
    {"port": record, "jax": record}."""
    records = {}
    sign_sentinel = object()
    for name, mod in (("port", tpc), ("jax", jpc)):
        record = records[name] = {}

        def open_(url, modifier=None, record=record):
            record["open"] = {"url": url, "modifier": modifier}
            return FakeCatalog(record)

        client = types.SimpleNamespace(Client=types.SimpleNamespace(open=open_))
        signer = types.SimpleNamespace(sign_inplace=sign_sentinel)
        monkeypatch.setattr(mod, "_pystac", lambda c=client, s=signer: (c, s))
    records["sign_sentinel"] = sign_sentinel
    return records


@pytest.mark.parametrize("getter,args,kw", [
    ("search_stac", ("naip", BBOX, "2019-01-01/2021-12-31"), {}),
    ("get_s2_stac", (BBOX, "2021-11-01/2022-05-01"), {"max_cloud": 10.0}),
    ("get_s1_stac", (BBOX, "2022-01-01/2022-02-01"), {"orbit": "ascending"}),
    ("get_naip_stac", (BBOX,), {}),
    ("get_dem_stac", (BBOX,), {}),
    ("get_hag_stac", (BBOX,), {}),
    ("get_ssurgo_stac", (BBOX,), {}),
])
def test_stac_getters_match_jax(fake_stac, getter, args, kw):
    got = getattr(tpc, getter)(*args, **kw)
    want = getattr(jpc, getter)(*args, **kw)
    assert got and [i.id for i in got] == [i.id for i in want]
    assert fake_stac["port"] == fake_stac["jax"]
    assert fake_stac["port"]["open"] == {"url": tpc.PC_STAC_URL,
                                         "modifier": fake_stac["sign_sentinel"]}


def test_search_stac_drains_pages(monkeypatch):
    pulls = []

    class PagedSearch:
        def items(self):
            for page in range(3):
                pulls.append(page)
                for i in range(2):
                    yield FakeItem({"id": f"p{page}i{i}",
                                    "properties": {"datetime": "2021-06-01T00:00:00Z"}})

    catalog = types.SimpleNamespace(search=lambda **kw: PagedSearch())
    client = types.SimpleNamespace(
        Client=types.SimpleNamespace(open=lambda url, modifier=None: catalog))
    monkeypatch.setattr(tpc, "_pystac",
                        lambda: (client, types.SimpleNamespace(sign_inplace=None)))
    assert [i.id for i in tpc.search_stac("naip", BBOX)] == [
        f"p{p}i{i}" for p in range(3) for i in range(2)]
    assert pulls == [0, 1, 2]


def test_stac_without_the_clients_raises():
    if importlib.util.find_spec("pystac_client") or importlib.util.find_spec(
            "planetary_computer"):
        pytest.skip("pystac-client / planetary-computer are installed")
    with pytest.raises(ImportError, match="pystac-client"):
        tpc.search_stac("naip", BBOX)


def test_pc_array_helpers_equal():
    rng = np.random.default_rng(0)
    stack = rng.uniform(0, 3000, (3, 5, 6, 5)).astype(np.float32)
    bands = ["B02", "B03", "B04", "B08", "SCL"]
    times = ["2021-12-02T16:04:59Z", "2022-01-25T00:00:00", "2022-03-07T16:01:51+00:00"]
    np.testing.assert_array_equal(tpc.harmonize_s2_stack(stack, times, bands),
                                  jpc.harmonize_s2_stack(stack, times, bands))
    with pytest.raises(ValueError, match="leading"):
        tpc.harmonize_s2_stack(stack, times[:2], bands)
    for after in (False, True):
        want = jpc.harmonize_to_old(stack, after)
        np.testing.assert_array_equal(tpc.harmonize_to_old(stack, after), want)
        # a tensor stays a tensor on its device
        got = tpc.harmonize_to_old(torch.from_numpy(stack), after)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    stack[0, 0, 0] = np.nan
    np.testing.assert_array_equal(tpc.normalize_xarray(stack), jpc.normalize_xarray(stack))
    np.testing.assert_array_equal(tpc.trim_to_chunk_multiple(stack, 4),
                                  jpc.trim_to_chunk_multiple(stack, 4))
    table = {attr: {int(k): v for k, v in tbl.items()}
             for attr, tbl in CANNED["ssurgo_attributes"].items()}
    mukey = np.array([[100001, 100002], [100003, 999999]])
    np.testing.assert_array_equal(tpc.join_ssurgo(mukey, table), jpc.join_ssurgo(mukey, table))


def test_retry_is_bounded():
    calls = []

    def flaky(fail):
        calls.append(1)
        if len(calls) <= fail:
            raise OSError("busy")
        return "ok"

    assert tpc.retry(flaky, 2, retries=3, delay=0.0) == "ok" and len(calls) == 3
    calls.clear()
    with pytest.raises(OSError):
        tpc.retry(flaky, 5, retries=3, delay=0.0)
    assert len(calls) == 3


def test_resign_vrt_equal(tmp_path):
    outs = {}
    for name, mod in (("port", tpc), ("jax", jpc)):
        d = tmp_path / name
        d.mkdir()
        (d / "warped_inner.vrt").write_text(
            "<VRTDataset><SourceDataset>https://x.blob.core.windows.net/a.tif?sig=OLD"
            "</SourceDataset></VRTDataset>")
        (d / "mosaic.vrt").write_text(
            "<VRTDataset><VRTRasterBand><SimpleSource><SourceFilename>"
            "https://x.blob.core.windows.net/b.tif?sig=OLD</SourceFilename></SimpleSource>"
            "<SimpleSource><SourceFilename>warped_inner.vrt</SourceFilename></SimpleSource>"
            "</VRTRasterBand></VRTDataset>")
        out = mod.resign_vrt(str(d / "mosaic.vrt"), signer=lambda u: f"{u}?sig=NEW")
        # the nested reference is rewritten to an absolute path
        outs[name] = [open(out).read().replace(str(d), "DIR"),
                      (d / "warped_inner_resigned.vrt").read_text()]
    assert outs["port"] == outs["jax"]
    assert "b.tif?sig=NEW" in outs["port"][0] and "a.tif?sig=NEW" in outs["port"][1]


# ---------------------------------------------------------------------------
# fake Earth Engine: record the server-side expression graph
# ---------------------------------------------------------------------------
class EENode:
    """Every method call returns a new node recording (receiver, op, args)
    into a shared trace."""

    _n = 0

    def __init__(self, trace, label):
        self.trace = trace
        self.label = label

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            EENode._n += 1
            out = EENode(self.trace, f"n{EENode._n}")
            self.trace.append((self.label, name, args, kwargs, out.label))
            return out

        return call


def _fake_ee_module(trace):
    class FakeEEModule:
        @staticmethod
        def Image(val):
            node = EENode(trace, f"Image({val})")
            trace.append(("ee", "Image", (val,), {}, node.label))
            return node

        @staticmethod
        def Initialize(**kwargs):
            trace.append(("ee", "Initialize", (), kwargs, None))

        Reducer = EENode(trace, "Reducer")
        Dictionary = EENode(trace, "Dictionary")

    return FakeEEModule


def _canonical(trace):
    """The trace with node labels renamed by first appearance, so two runs
    compare equal when they build the same graph."""
    names = {}

    def name(x):
        if isinstance(x, EENode):
            x = x.label
        if isinstance(x, str) and (x.startswith("n") and x[1:].isdigit()):
            return names.setdefault(x, f"node{len(names)}")
        if isinstance(x, (tuple, list)):
            return type(x)(name(v) for v in x)
        if isinstance(x, dict):
            return {k: name(v) for k, v in x.items()}
        return x

    return [tuple(name(v) for v in entry) for entry in trace]


@pytest.fixture()
def fake_ee(monkeypatch):
    traces = {"port": [], "jax": []}
    modules = {}
    for name, mod in (("port", tee), ("jax", jee)):
        modules[name] = _fake_ee_module(traces[name])
        monkeypatch.setattr(mod, "_ee", lambda m=modules[name]: m)
    return traces, modules


@pytest.mark.parametrize("builder,extra", [
    ("basic_qa", ()), ("mask_l8_sr", ()), ("mask_sr", ()), ("sentinel2toa", ()),
    ("rescale_expression", ("img.B2", (0.1, 0.5))), ("sentinel_cloud_score", ()),
    ("normalize", ("@max", "@min")), ("standardize", (300,)),
    ("lda_score", (0.5, ["B2", "B8"], [1.5, -2.0])),
])
def test_ee_builders_match_jax(fake_ee, builder, extra):
    traces, _ = fake_ee
    for name, mod in (("port", tee), ("jax", jee)):
        args = [EENode(traces[name], a) if str(a).startswith("@") else a for a in extra]
        getattr(mod, builder)(EENode(traces[name], "img"), *args)
    assert traces["port"] and _canonical(traces["port"]) == _canonical(traces["jax"])


def test_ee_initialize_export_and_wait_match_jax(fake_ee):
    traces, modules = fake_ee
    captured = {"port": {}, "jax": {}}
    for name, mod in (("port", tee), ("jax", jee)):
        mod.initialize(project="p")

        class FakeTask:
            def start(self, c=captured[name]):
                c["started"] = True

        def to_cloud_storage(c=captured[name], **kwargs):
            c.update(kwargs)
            return FakeTask()

        modules[name].batch = types.SimpleNamespace(Export=types.SimpleNamespace(
            image=types.SimpleNamespace(toCloudStorage=to_cloud_storage)))
        mod.export_image_patches(image="IMG", bucket="bkt", path="solar/va", base="p2022",
                                 region="REGION")
    assert captured["port"] == captured["jax"] and captured["port"]["started"]
    assert _canonical(traces["port"]) == _canonical(traces["jax"])

    class Task:
        id = "T1"

        def __init__(self, states):
            self.states = list(states)

        def active(self):
            return len(self.states) > 1 and self.states.pop(0) == "RUNNING"

        def status(self):
            return {"state": self.states[-1], "error_message": "quota"}

    logs = []
    assert tee.wait_for_task(Task(["RUNNING", "COMPLETED"]), poll_seconds=0,
                             log_fn=logs.append)["state"] == "COMPLETED"
    assert logs == ["task T1: running..."]
    for mod in (tee, jee):
        with pytest.raises(RuntimeError, match="quota"):
            mod.wait_for_task(Task(["FAILED"]), poll_seconds=0, log_fn=logs.append)


def test_ee_without_the_package_raises():
    if importlib.util.find_spec("ee"):
        pytest.skip("earthengine-api is installed")
    with pytest.raises(ImportError, match="satellite_computervision_tpu_torch.cloud.masking"):
        tee.initialize()


# ---------------------------------------------------------------------------
# blob IO
# ---------------------------------------------------------------------------
def test_blob_roundtrip_and_upload(tmp_path):
    arr = np.random.default_rng(1).normal(size=(4, 5, 2)).astype(np.float32)
    path = str(tmp_path / "sub" / "chip.npy")
    tblob.save_numpy(arr, path)
    np.testing.assert_array_equal(jblob.load_numpy(path), arr)
    np.testing.assert_array_equal(tblob.load_numpy(path), arr)
    url = "file://" + path
    assert tblob.fetch_bytes(url) == jblob.fetch_bytes(url) == open(path, "rb").read()

    uploads = {"port": {}, "jax": {}}
    for name, mod in (("port", tblob), ("jax", jblob)):
        container = types.SimpleNamespace(upload_blob=lambda name, data, overwrite, u=uploads[
            name]: u.update(name=name, data=data.read(), overwrite=overwrite))
        mod.save_numpy(arr, "chips/x.npy", container=container)
    assert uploads["port"] == uploads["jax"] and uploads["port"]["name"] == "chips/x.npy"
    np.testing.assert_array_equal(np.load(io.BytesIO(uploads["port"]["data"])), arr)


def test_blob_without_the_sdk_raises():
    if importlib.util.find_spec("azure"):
        pytest.skip("azure-storage-blob is installed")
    with pytest.raises(ImportError, match="azure-storage-blob"):
        tblob.get_container_client("conn", "c")


def test_cloud_package_exports():
    assert tcloud.__all__ == ["masking", "calibration", "blob", "ee", "pc"]


# ---------------------------------------------------------------------------
# calibration (host numpy in both)
# ---------------------------------------------------------------------------
def _scenes(seed, n=3, shape=(40, 36, 2)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = (rng.gamma(2.0 + i, 300.0, shape) * (1.0 + 0.2 * i)).astype(np.float32)
        s[i, :5] = np.nan
        out.append(s)
    return out


def test_calibration_helpers_equal():
    a, b, _ = _scenes(0)
    for pct in ((1, 99), (5, 95)):
        np.testing.assert_array_equal(tcal.clamp_and_scale(a, pct), jcal.clamp_and_scale(a, pct))
    np.testing.assert_array_equal(tcal.scene_median(a), jcal.scene_median(a))
    va, vb = np.isfinite(a[..., 0]), np.isfinite(b[..., 0])
    np.testing.assert_array_equal(tcal.overlap_mask(va, vb), jcal.overlap_mask(va, vb))
    for n_bins in (16, 256):
        for g, w in zip(tcal.histogram_cdf(a, n_bins), jcal.histogram_cdf(a, n_bins)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tcal.match_histogram(a, b, n_bins),
                                      jcal.match_histogram(a, b, n_bins))
    overlap = va & vb
    for fc_t, fc_j in zip(tcal.make_FC(a, overlap, 512), jcal.make_FC(a, overlap, 512)):
        for g, w in zip(fc_t, fc_j):
            np.testing.assert_array_equal(g, w)
    x, y = np.sort(np.random.default_rng(2).uniform(0, 1, 50)), np.linspace(0, 1, 50)
    q = np.random.default_rng(3).uniform(-0.1, 1.1, 20)
    np.testing.assert_array_equal(
        tcal._rf_regress_1d(x, y, q, 10, np.random.default_rng(4)),
        jcal._rf_regress_1d(x, y, q, 10, np.random.default_rng(4)))


@pytest.mark.parametrize("overlap", [False, True])
def test_equalize_equal(overlap):
    scenes = _scenes(5)
    mask = np.isfinite(scenes[0][..., 0]) & np.isfinite(scenes[1][..., 0]) if overlap else None
    np.testing.assert_array_equal(tcal.equalize_scene(scenes[1], scenes[0], mask),
                                  jcal.equalize_scene(scenes[1], scenes[0], mask))
    np.testing.assert_array_equal(tcal.equalize_rf(scenes[1], scenes[0], mask, seed=7),
                                  jcal.equalize_rf(scenes[1], scenes[0], mask, seed=7))
    overlaps = [mask, mask] if overlap else None
    got = tcal.equalize_collection(scenes, overlaps)
    want = jcal.equalize_collection(scenes, overlaps)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tcal.equalize_collection([]) == []
