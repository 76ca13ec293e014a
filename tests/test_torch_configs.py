"""The port's model registry against the reference's: the six dense configs,
whisper-medium, the two MoE configs and the two recurrent ones (hymba-1.5b,
xlstm-350m) equal field for field (internvl2-2b: tests/test_torch_vlm.py),
a name the port would not serve yet raising ``NotImplementedError`` with
its ROADMAP item (none is left: the path is held with a faked entry),
unknown names ``KeyError``;
and the widths of the registry through the port's layout helpers
(``padded_vocab``, ``head_layout`` at tp 1/2/4/8, the int8 reduce's
shards)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import ModelConfig as RModelConfig
from repro.config import get_model_config as r_get
from repro.config import padded_vocab as r_padded_vocab
from repro.configs import PAPER as R_PAPER
from repro.layers.heads import head_layout as r_head_layout

from repro_torch.config import ModelConfig, get_model_config, padded_vocab
from repro_torch.configs import DENSE, ENCDEC, MOE, PAPER, RECURRENT, \
    UNPORTED
from repro_torch.kernels import int8_quant as q8
from repro_torch.layers.heads import head_layout


def test_model_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(RModelConfig)]


@pytest.mark.parametrize("name", DENSE)
def test_dense_config_equals_reference(name):
    got, want = get_model_config(name), r_get(name)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert got.resolved_head_dim == want.resolved_head_dim == 128


@pytest.mark.parametrize("name", ENCDEC)
def test_encdec_config_equals_reference(name):
    """whisper-medium is served (by the dense Engine): its fields and
    parameter count are the reference's, and no longer in ``UNPORTED``."""
    got, want = get_model_config(name), r_get(name)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert (got.d_model, got.num_heads, got.num_kv_heads,
            got.resolved_head_dim, got.d_ff, got.vocab_size,
            got.num_layers, got.encoder_layers, got.encoder_frames) == \
        (1024, 16, 16, 64, 4096, 51865, 24, 24, 1500)
    assert got.source == "arXiv:2212.04356"
    assert name not in UNPORTED
    assert padded_vocab(got, 1) == r_padded_vocab(want, 1) == 53248


@pytest.mark.parametrize("name", MOE)
def test_moe_config_equals_reference(name):
    """granite-moe-3b-a800m and kimi-k2-1t-a32b are served: fields (the
    ``MoEConfig`` included), ``param_count`` whole and ``active_only``, and
    the padded expert counts equal to the reference's, and neither is in
    ``UNPORTED``."""
    got, want = get_model_config(name), r_get(name)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "moe":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    for active in (False, True):
        assert got.param_count(active_only=active) == \
            want.param_count(active_only=active)
    for tp in (1, 2, 4, 16):
        assert got.moe.padded_experts(tp) == want.moe.padded_experts(tp)
    assert got.block_pattern == ("attn_moe",) and got.family == "moe"
    assert name not in UNPORTED


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_config_equals_reference(name):
    """hymba-1.5b and xlstm-350m are served: fields (the ``SSMConfig``
    included), ``param_count`` (with the reference's omissions: the SSM's
    w_dt, w_b and w_c are not counted) and the head layout at tp 1/2/4
    equal to the reference's, and neither is in ``UNPORTED``."""
    got, want = get_model_config(name), r_get(name)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "ssm":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.ssm is None) == (want.ssm is None)
    if got.ssm is not None:
        assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
    assert got.param_count() == want.param_count()
    for tp in (1, 2, 4):
        assert dataclasses.astuple(head_layout(
            got.num_heads, got.num_kv_heads, tp)) == dataclasses.astuple(
            r_head_layout(want.num_heads, want.num_kv_heads, tp))
        assert padded_vocab(got, tp) == r_padded_vocab(want, tp)
    assert name not in UNPORTED
    if name == "hymba-1.5b":
        assert (got.family, got.sliding_window, got.num_heads,
                got.num_kv_heads, got.resolved_head_dim) == \
            ("hybrid", 2048, 25, 5, 64)
        assert got.param_count() == 1_639_427_200
    else:
        assert got.block_pattern == ("mlstm",) * 3 + ("slstm",)


def test_paper_list_matches_reference():
    assert PAPER == R_PAPER == ["paper-30b", "paper-70b"]


@pytest.mark.parametrize("name,item", [("internvl2-2b", 99)])
def test_unported_name_raises_with_item(monkeypatch, name, item):
    """Every registered name is ported (``UNPORTED`` is empty); an entry
    there still makes ``get_model_config`` raise naming its item."""
    from repro_torch import configs
    assert UNPORTED == {}
    monkeypatch.setitem(configs.UNPORTED, name, item)
    r_get(name)                              # the reference registers it
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        get_model_config(name)


def test_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        get_model_config("no-such-arch")


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_registry_layouts_match_reference(name, tp):
    """Padded vocab and the TP head layout of each dense config equal the
    reference's at every degree; pad slots only where the kv heads do not
    divide (paper-30b's 52 at tp=8: 56 slots, 4 of them zero)."""
    cfg = get_model_config(name)
    assert padded_vocab(cfg, tp) == r_padded_vocab(r_get(name), tp)
    assert padded_vocab(cfg, tp) % (tp * 128) == 0
    got = head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    assert dataclasses.astuple(got) == dataclasses.astuple(
        r_head_layout(cfg.num_heads, cfg.num_kv_heads, tp))
    pad_kv = sum(h < 0 for h in got.kv_map)
    hkv = cfg.num_kv_heads
    assert (pad_kv == 0) == (hkv % tp == 0 or tp % hkv == 0)
    if name == "paper-30b" and tp == 8:
        assert (got.hkv_eff, pad_kv, got.group_eff) == (56, 4, 1)


@pytest.mark.parametrize("d", [6656, 8192])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_int8_reduce_shards_at_registry_widths(d, tp):
    """The int8 all-reduce's three steps at paper-30b's and paper-70b's
    d_model: a simulated exchange of tp ranks' partials gives each rank's
    sum within the int8 quantization error, in x's layout and dtype."""
    rng = np.random.default_rng(d + tp)
    xs = [torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
          for _ in range(tp)]
    shards = [q8.quantize_int8_shards(x, tp) for x in xs]
    assert shards[0][0].shape == (tp, 3, d // tp)
    # rank r receives shard r of every rank, sums and re-quantizes it
    reduced = [q8.dequant_sum_quantize_int8(
        torch.stack([q[r] for q, _ in shards]),
        torch.stack([s[r] for _, s in shards])) for r in range(tp)]
    q = torch.stack([q for q, _ in reduced])
    s = torch.stack([s for _, s in reduced])
    out = q8.dequantize_int8_gathered(q, s, torch.float32)
    want = torch.stack(xs).sum(0)
    assert out.shape == want.shape
    scale = want.abs().amax(-1, keepdim=True) / 127
    assert ((out - want).abs() <= (tp + 1) * scale).all()


@pytest.mark.parametrize("name", DENSE)
def test_serve_launcher_takes_every_dense_arch(name, capsys):
    """``--arch <name> --preset tiny --device cpu``: the launcher's reduced
    twin of each dense config serves on the CPU; an unported name raises
    naming its item."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", name, "--preset", "tiny", "--paged",
                       "--device", "cpu", "--dtype", "float32",
                       "--requests", "2", "--prompt-len", "40",
                       "--max-new", "3", "--prefill-budget", "16"]) == 0
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "completed=2" in out


def test_serve_launcher_refuses_unported_arch(monkeypatch):
    """An arch in ``UNPORTED`` (none is left; one is faked) stops the
    launcher before it builds anything."""
    from repro_torch import configs
    from repro_torch.launch import serve
    monkeypatch.setitem(configs.UNPORTED, "internvl2-2b", 99)
    with pytest.raises(NotImplementedError, match="queue A item 99"):
        serve.main(["--arch", "internvl2-2b", "--paged", "--device", "cpu"])
