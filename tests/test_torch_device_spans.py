"""Device spans (``utils/tracing.device_span``) and the backbone's
``<stage>.net.<child>`` spans around each kept child of ``Features``.

On the CPU a device span is a host span; its CUDA path is checked here with
stand-in events and synchronise, and on the card by the ``gpu`` case. This
file imports no JAX, so the card runs it as it runs ``test_torch_gpu.py``:

    python -m pytest tests/test_torch_device_spans.py -m gpu --noconftest -p no:cacheprovider
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from shoeprint_image_retrieval_torch.config import load_config
from shoeprint_image_retrieval_torch.models.densenet import CHILD_NAMES, densenet201
from shoeprint_image_retrieval_torch.retrieval.engine import Pipeline
from shoeprint_image_retrieval_torch.utils import tracing
from shoeprint_image_retrieval_torch.utils.tracing import device_span, stage_timer

RUN_TOML = """
[dataset]
dir = "{dir}"
type = "Impress"
crop = [0.05, 0.05]
n_processes = 2
n_clusters = 2
cluster_minimise_tolerance = 0.05

[model]
type = "{model}"
clahe_clip_limit = 2.0
clahe_tile_grid_size = [8, 8]
start_block = {start}
end_block = {end}
skip_blocks = []
minimum_dim = 40
maximum_dim = 200

[comparison]
n_processes = 2
rotations = [9]
scales = [1.04]

[tpu]
extraction_batch = 4
probe_batch = 2
pipeline_clusters = false
profile_dir = "{profile}"
"""


def _dataset(root, rng):
    """Six prints and four crops of them, two of each crop size: with
    ``minimum_dim = 40`` the small crops plan one block below the large."""
    (root / "Gallery").mkdir(parents=True)
    (root / "Query").mkdir()
    prints = {}
    for gi in range(1, 7):
        prints[gi] = rng.integers(30, 220, size=(int(rng.integers(70, 90)),
                                                 int(rng.integers(60, 80))), dtype=np.uint8)
        Image.fromarray(prints[gi]).save(root / "Gallery" / f"{gi}_1.png")
    for qi, (y0, y1, x0, x1) in enumerate([(5, 55, 5, 50), (3, 40, 4, 36)] * 2):
        gid = qi + 1
        Image.fromarray(prints[gid][y0:y1, x0:x1]).save(root / "Query" / f"{gid}_q{qi}.png")


@pytest.mark.parametrize("model,start,end,children", [
    ("EfficientNetV2_M", 3, 2, [str(i) for i in range(3)]),
    ("DenseNet_201", 6, 5, list(CHILD_NAMES[:6])),
])
def test_extraction_spans_one_key_per_kept_child(tmp_path, model, start, end, children):
    """Both clusters on the calling thread: each extraction stage holds one
    ``net.<child>`` key per child of the deeper cluster's backbone, within
    the stage's seconds, and the trace holds their ranges inside the
    stage's."""
    _dataset(tmp_path / "data", np.random.default_rng(3))
    cfg = tmp_path / "run.toml"
    cfg.write_text(RUN_TOML.format(dir=tmp_path / "data", model=model, start=start, end=end,
                                   profile=tmp_path / "traces"))
    pipe = Pipeline(load_config(cfg), weights_dir=None, verbose=False, device="cpu")
    assert sorted(p.block for p in pipe.plans) == [end, start]
    assert len(list(pipe.run())) == 2
    st = pipe.stage_seconds
    for stage in ("extract-query", "extract-gallery"):
        keys = {k for k in st if k.startswith(f"{stage}.net.")}
        assert keys == {f"{stage}.net.{c}" for c in children}
        assert 0.0 < sum(st[k] for k in keys) <= st[stage]
    assert not pipe.lookahead_seconds
    events = json.loads((tmp_path / "traces" / "cluster0.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"]
    stages = [e for e in ranges if e["name"] == "extract-gallery"]
    for c in children[: pipe.plans[0].block]:
        spans = [e for e in ranges if e["name"] == f"extract-gallery.net.{c}"]
        assert spans and all(any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                                 for s in stages) for e in spans)


def test_device_span_off_a_card_is_a_host_span():
    sink = {}
    with stage_timer("extract", verbose=False, sink=sink):
        with device_span("net.conv0", torch.device("cpu")):
            pass
    assert set(sink) == {"extract", "extract.net.conv0"}
    assert 0.0 <= sink["extract.net.conv0"] <= sink["extract"]
    with device_span("net.conv0", torch.device("cpu")):  # no stage: the range alone
        pass
    assert tracing._open.stages == []


class _Event:
    """A stand-in CUDA event: ``elapsed_time`` is 3 ms between the records,
    and raises where the device was not synchronised after them."""

    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.log.append(("record", stream))

    def elapsed_time(self, end):
        assert self.log[-1] == ("synchronize", None)
        return 3.0


@pytest.fixture
def fake_card(monkeypatch):
    _Event.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: f"stream{device.index}")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: _Event.log.append(("synchronize", None)))
    return _Event.log


def test_device_span_on_a_card_reads_its_events_after_the_stages_synchronise(fake_card):
    sink = {}
    with stage_timer("extract-gallery", verbose=False, sink=sink, device=torch.device("cuda")):
        for part in ("net.conv0", "net.denseblock1", "net.conv0"):
            with device_span(part, torch.device("cuda:0")):
                pass
        # work on another card than the one the stage synchronises: the host's time
        with device_span("net.norm0", torch.device("cuda:1")):
            pass
        assert "extract-gallery.net.conv0" not in sink
    assert fake_card.count(("synchronize", None)) == 1
    assert fake_card.count(("record", "stream0")) == 6
    assert sink["extract-gallery.net.conv0"] == pytest.approx(0.006)
    assert sink["extract-gallery.net.denseblock1"] == pytest.approx(0.003)
    assert "extract-gallery.net.norm0" in sink


def test_device_span_in_a_stage_that_never_synchronises_is_a_host_span(fake_card):
    """The lookahead thread's stages have no device: its spans stay host
    spans, and no event is recorded."""
    sink = {}
    with stage_timer("extract-gallery", verbose=False, sink=sink):
        with device_span("net.conv0", torch.device("cuda:0")):
            pass
    assert fake_card == [] and set(sink) == {"extract-gallery", "extract-gallery.net.conv0"}


def test_a_failed_stage_reads_no_event(fake_card):
    sink = {}
    with pytest.raises(RuntimeError):
        with stage_timer("extract-gallery", verbose=False, sink=sink,
                         device=torch.device("cuda")):
            with device_span("net.conv0", torch.device("cuda:0")):
                raise RuntimeError("boom")
    assert ("synchronize", None) not in fake_card
    assert set(sink) == {"extract-gallery"}
    assert tracing._open.stages == []


@pytest.mark.gpu
def test_device_spans_on_the_card_hold_device_seconds_without_a_synchronise(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    model = densenet201(8).to(dev).eval()
    x = torch.randn((8, 3, 320, 256), device=dev)
    valid = torch.tensor([[320, 256]] * 8, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        model(x, valid)
        torch.cuda.synchronize(dev)
        calls = []
        real = torch.cuda.synchronize
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: (calls.append(device), real(device)))
        sink = {}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with stage_timer("extract-gallery", verbose=False, sink=sink, device=dev):
            start.record()
            model(x, valid)
            end.record()
    assert calls == [dev]
    keys = [f"extract-gallery.net.{c}" for c in CHILD_NAMES[:8]]
    assert sorted(k for k in sink if ".net." in k) == sorted(keys)
    assert all(sink[k] > 0.0 for k in keys)
    # the children's device seconds lie inside the forward's own events
    assert sum(sink[k] for k in keys) <= start.elapsed_time(end) / 1e3 <= sink["extract-gallery"]
