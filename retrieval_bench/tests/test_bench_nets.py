"""The plain backbones, one file an architecture under ``reference/nets/``:
each reads as the single-module reference did, every file keeps the
contract, and a new architecture plugs in as a file alone."""

from __future__ import annotations

import hashlib
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from retrieval_bench import flops, harness, weights
from retrieval_bench.check import Reference
from retrieval_bench.reference import backbones, ingest

SIZES = [(64, 56), (97, 83), (300, 241)]

# Taken from the single-module reference (``reference/backbones.py`` before
# the per-architecture files) on the CPU with one thread: the number of
# state-dict keys and a hash of "key shape kind" lines, a hash of the keys
# and bytes of ``weights.make(..., seed=0)``, ``out_size`` and ``conv_flop``
# at SIZES, and the exact sum and sum of squares (``float.hex``) of the
# float64 forward pass of one seeded 64 x 56 image.
FROZEN = {
    ("EfficientNetV2_M", 3): (
        70, "22ee7f993581d965d71756a91d70fc8a736d0c04271c7c096be5a3700dee3ef0",
        "c0878f20fa614fc2813a6d1181d3afeb8d39a69507af5349e99777fe218d0131",
        [(16, 14), (25, 21), (75, 61)], [205535232.0, 480362400.0, 4193013600.0],
        (1, 48, 16, 14), ("-0x1.0f3471e459a9fp+5", "0x1.7c983683eaceap+5")),
    ("EfficientNetV2_M", 4): (
        120, "d6890cb272622ca9fb53f0c68820eccc6b91e3d01b445e1ff2fc2a5134573977",
        "2e6f75044e6359ab9d83db11cc38d93fb97b23c0ab37ab2484c2810ea4be4e95",
        [(8, 7), (13, 11), (38, 31)], [331233280.0, 801341344.0, 6837161824.0],
        (1, 80, 8, 7), ("-0x1.c8161e7d3dffbp-2", "0x1.21f44c20712fap-1")),
    ("EfficientNetV2_M", 6): (
        519, "4e2e7e31d69860542b3e6d175da696ea7fec974ce6dd0b78a093302e76d58a85",
        "782f7d13ea12ba257a7984b1da3a9a30b02dad98c416767d452b5986c480ae2a",
        [(4, 4), (7, 6), (19, 16)], [548652544.0, 1366646304.0, 10916189536.0],
        (1, 176, 4, 4), ("0x1.ad2975f4befa9p-12", "0x1.582aeca12cd4dp-24")),
    ("VGG16", 10): (
        8, "7dcee23ce299c26dee959e432896ad3f0fed49a4054f19ce2d42a01a4d7c1607",
        "e18c1793feacc5b9fca5d20fb7b272fc068f7d955f36d017caff268d1b33b32b",
        [(16, 14), (24, 20), (75, 60)], [672989184.0, 1491988608.0, 13543027200.0],
        (1, 128, 16, 14), ("0x1.50f84b248da7cp+10", "0x1.1423c63c2c298p+7")),
    ("VGG16", 17): (
        14, "0cf6f49f6d3b8f316dcb9a8340258b7c5dbb12f6139966315c8e466792698a76",
        "9da02c6d4c699c93c3eda5fbac7cb4b1e80f76d1d4fff80d2e9ccc3886c93033",
        [(8, 7), (12, 10), (37, 30)], [1333592064.0, 2907566208.0, 26814067200.0],
        (1, 256, 8, 7), ("0x1.98ece04b30cb2p+6", "0x1.e0d3c0c4156e8p+0")),
    ("VGG16", 24): (
        20, "0774b68cfb426c6cbe34d5a58c49aae8d48c10bbb9a5a70fab753a61fccbc524",
        "26eb630edbbf774f6f6450fede2e2dce00c8d4a36135a4e9e6143f759c0de753",
        [(4, 3), (6, 5), (18, 15)], [1994194944.0, 4323143808.0, 39908160000.0],
        (1, 512, 4, 3), ("0x1.94d00ee24d559p+4", "0x1.2b09cef167502p-2")),
}


@pytest.fixture
def one_thread():
    """Float64 convs sum in an order that follows the thread count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("model,block", list(FROZEN), ids=lambda v: str(v))
def test_reads_as_the_single_module_reference_did(model, block, one_thread):
    n_keys, shapes_sha, weights_sha, sizes, conv, shape, (total, squares) = FROZEN[model, block]
    net = backbones.network(model, block)
    shapes = backbones.param_shapes(net)
    lines = "\n".join(f"{k} {tuple(s)} {kind}" for k, (s, kind) in shapes.items())
    assert (len(shapes), hashlib.sha256(lines.encode()).hexdigest()) == (n_keys, shapes_sha)
    w = weights.make(model, block, 0, torch.device("cpu"))
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == weights_sha
    assert [backbones.out_size(net, hw) for hw in SIZES] == sizes
    assert [backbones.conv_flop(net, hw) for hw in SIZES] == conv
    x = torch.randn((1, 3, 64, 56), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    with torch.inference_mode():
        y = backbones.forward(net, {k: v.double() for k, v in w.items()}, x)
    vals = y.flatten().tolist()
    assert tuple(y.shape) == shape
    assert (math.fsum(vals).hex(), math.fsum(v * v for v in vals).hex()) == (total, squares)


def counted_conv(monkeypatch) -> list[float]:
    """FLOP of every ``F.conv2d`` called from here on, counted from the
    output and the weight."""
    counted = []
    real = F.conv2d

    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        y = real(x, weight, bias, stride, padding, dilation, groups)
        counted.append(2.0 * y.numel() * weight.shape[1] * weight.shape[2] * weight.shape[3])
        return y

    monkeypatch.setattr(F, "conv2d", conv)
    return counted


NET_FILES = sorted(p.stem for p in backbones.NETS.glob("*.py"))


@pytest.mark.parametrize("model,block", [(m, b) for m in NET_FILES
                                         for b in backbones.architecture(m).BLOCKS],
                         ids=lambda v: str(v))
def test_every_net_file_keeps_the_contract(model, block, monkeypatch):
    """Forward shape against ``out_size`` and ``channels``, counted conv FLOP
    against ``conv_flop``, the drawn keys against ``param_shapes``."""
    net = backbones.network(model, block)
    mean, std = backbones.normalisation(net)
    assert len(mean) == len(std) == 3
    w = weights.make(model, block, 3, torch.device("cpu"))
    assert list(w) == list(backbones.param_shapes(net))
    counted = counted_conv(monkeypatch)
    hw = (67, 59)
    with torch.inference_mode():
        y = backbones.forward(net, w, torch.zeros((1, 3, *hw)))
    assert tuple(y.shape) == (1, backbones.channels(net), *backbones.out_size(net, hw))
    assert backbones.conv_flop(net, hw) == sum(counted)


def test_a_missing_file_raises_lookup_error():
    for name in ("ResNet50", "../nets/VGG16", ""):
        with pytest.raises(LookupError):
            backbones.network(name, 3)


# A DenseNet-shaped toy, written as a later configuration's file would be:
# its own layer table, state-dict keys, size and FLOP arithmetic and forward
# pass, none of them the shared ``Op`` interpreter's.
TOY = '''
"""A DenseNet-shaped toy: stem conv, BatchNorm, ReLU and a padded 3 x 3 max
pool; one dense layer concatenated onto its input; one transition (BN,
ReLU, 1 x 1 conv, 2 x 2 average pool)."""

import torch
import torch.nn.functional as F

NORMALISATION = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
BLOCKS = range(1, 7)
EPS = 1e-5
GROWTH, MID, STEM = 4, 8, 6

# features' children: ("conv", key, in, out, kernel, stride, pad),
# ("bn", key, channels), ("relu",), ("maxpool", kernel, stride, pad),
# ("avgpool", kernel, stride), ("dense", key, in)
CHILDREN = [
    [("conv", "features.conv0", 3, STEM, 3, 2, 1)],
    [("bn", "features.norm0", STEM)],
    [("relu",)],
    [("maxpool", 3, 2, 1)],
    [("dense", "features.denseblock1.denselayer1", STEM)],
    [("bn", "features.transition1.norm", STEM + GROWTH), ("relu",),
     ("conv", "features.transition1.conv", STEM + GROWTH, (STEM + GROWTH) // 2, 1, 1, 0),
     ("avgpool", 2, 2)],
]


def layers(block):
    return [op for child in CHILDREN[:block] for op in child]


def _dense(key, cin):
    return [("bn", f"{key}.norm1", cin), ("relu",), ("conv", f"{key}.conv1", cin, MID, 1, 1, 0),
            ("bn", f"{key}.norm2", MID), ("relu",), ("conv", f"{key}.conv2", MID, GROWTH, 3, 1, 1)]


def channels(table):
    c = 3
    for op in table:
        c = op[3] if op[0] == "conv" else c + GROWTH if op[0] == "dense" else c
    return c


def _walk(table, hw):
    h, w = hw
    total = 0.0
    for op in table:
        if op[0] == "conv":
            _, _, cin, cout, k, s, p = op
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            total += 2.0 * cin * k * k * cout * h * w
        elif op[0] == "maxpool":
            _, k, s, p = op
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif op[0] == "avgpool":
            _, k, s = op
            h, w = (h - k) // s + 1, (w - k) // s + 1
        elif op[0] == "dense":
            total += _walk(_dense(op[1], op[2]), (h, w))[2]
    return h, w, total


def out_size(table, hw):
    return _walk(table, hw)[:2]


def conv_flop(table, hw):
    return _walk(table, hw)[2]


def param_shapes(table):
    out = {}
    for op in table:
        if op[0] == "conv":
            out[f"{op[1]}.weight"] = ((op[3], op[2], op[4], op[4]), "conv")
        elif op[0] == "bn":
            for name, kind in (("weight", "one"), ("bias", "zero"),
                               ("running_mean", "zero"), ("running_var", "one")):
                out[f"{op[1]}.{name}"] = ((op[2],), kind)
        elif op[0] == "dense":
            out.update(param_shapes(_dense(op[1], op[2])))
    return out


def forward(table, weights, x):
    for op in table:
        if op[0] == "conv":
            x = F.conv2d(x, weights[f"{op[1]}.weight"], None, op[5], op[6])
        elif op[0] == "bn":
            k = op[1]
            x = F.batch_norm(x, weights[f"{k}.running_mean"], weights[f"{k}.running_var"],
                             weights[f"{k}.weight"], weights[f"{k}.bias"], False, 0.0, EPS)
        elif op[0] == "relu":
            x = F.relu(x)
        elif op[0] == "maxpool":
            x = F.max_pool2d(x, op[1], op[2], op[3])
        elif op[0] == "avgpool":
            x = F.avg_pool2d(x, op[1], op[2])
        elif op[0] == "dense":
            x = torch.cat([x, forward(_dense(op[1], op[2]), weights, x)], 1)
    return x
'''


def toy_by_hand(w, x):
    """The toy's six children written out in ``torch.nn.functional``."""
    def bn(x, k):
        return F.batch_norm(x, w[f"{k}.running_mean"], w[f"{k}.running_var"], w[f"{k}.weight"],
                            w[f"{k}.bias"], False, 0.0, 1e-5)

    x = F.conv2d(x, w["features.conv0.weight"], stride=2, padding=1)
    x = F.max_pool2d(F.relu(bn(x, "features.norm0")), 3, 2, 1)
    d = "features.denseblock1.denselayer1"
    y = F.conv2d(F.relu(bn(x, f"{d}.norm1")), w[f"{d}.conv1.weight"])
    y = F.conv2d(F.relu(bn(y, f"{d}.norm2")), w[f"{d}.conv2.weight"], padding=1)
    x = torch.cat([x, y], 1)
    t = "features.transition1"
    return F.avg_pool2d(F.conv2d(F.relu(bn(x, f"{t}.norm")), w[f"{t}.conv.weight"]), 2, 2)


def test_a_new_architecture_plugs_in_as_a_file_alone(tmp_path, monkeypatch):
    nets = tmp_path / "nets"
    nets.mkdir()
    (nets / "ToyDense.py").write_text(TOY)
    monkeypatch.setattr(backbones, "NETS", nets)
    block, device = 6, torch.device("cpu")

    # the seeded weights: every key the file names, convs inside their bound
    net = backbones.network("ToyDense", block)
    shapes = backbones.param_shapes(net)
    w = weights.make("ToyDense", block, 2**31 + 5, device)
    assert list(w) == list(shapes)
    for k, (shape, kind) in shapes.items():
        assert tuple(w[k].shape) == shape
        if kind == "conv":
            assert 0 < w[k].abs().max() <= 1 / math.sqrt(math.prod(shape[1:]))
    # BatchNorm away from the identity, so that eps and the statistics count
    rng = torch.Generator().manual_seed(9)
    for k in w:
        if k.endswith(("norm0.weight", "norm1.bias", "norm2.running_mean", "norm.running_var")):
            w[k] = torch.rand(w[k].shape, generator=rng) + 0.5

    # a tiny dataset: the reference's features against the toy by hand
    rs = np.random.default_rng(4)
    sizes = {"Query": {"7_q1.png": (86, 94)},
             "Gallery": {"7_1.png": (100, 122), "8_1.png": (104, 117)}}
    for sub, files in sizes.items():
        (tmp_path / sub).mkdir()
        for name, (wd, ht) in files.items():
            img = rs.integers(0, 256, (ht, wd), dtype=np.uint8)
            Image.fromarray(img).save(tmp_path / sub / name)
    config = {"model": {"type": "ToyDense", "clahe_clip_limit": 2.0,
                        "clahe_tile_grid_size": [8, 8]},
              "dataset": {"crop": [0.05, 0.05]},
              "comparison": {"rotations": [-3, 3], "scales": [1.04]}}
    ref = Reference(tmp_path, config, w, 1.0, block, torch.float64, device)
    w64 = {k: v.double() for k, v in w.items()}
    counted = counted_conv(monkeypatch)
    backbone = {}
    for sub, files in sizes.items():
        for name, wh in files.items():
            img = ingest.load(tmp_path / sub / name, 1.0, config["dataset"]["crop"])
            assert img.shape == flops.ingest_hw(wh, config["dataset"]["crop"], 1.0)
            x = ingest.normalise(ingest.clahe(img, 2.0, [8, 8]), *backbones.normalisation(net),
                                 torch.float64, device)
            del counted[:]
            got = ref.maps(sub, name)
            backbone[name] = (sum(counted), tuple(got.shape))
            assert torch.equal(got, toy_by_hand(w64, x)[0])

    # the harness's size and FLOP path, against the counted forward passes
    plan = types.SimpleNamespace(scale=1.0, block=block)
    work = harness.work_model(config, plan, sizes)
    gvalid = np.asarray([backbone[g][1][1:] for g in sizes["Gallery"]]) - 2 * flops.EDGE
    for mark in sizes["Query"]:
        flop, (c, h, wd) = backbone[mark]
        rows = flops.variant_windows((h, wd), 2, [1.04])
        assert work["marks"][mark] == {"flop": flops.needed_flop(rows, gvalid, c),
                                       "bytes": flops.correlation_bytes(rows, gvalid, c),
                                       "backbone": flop}
    assert work["gallery_backbone"] == sum(backbone[g][0] for g in sizes["Gallery"])

