"""Greedy tokens picked on the device in ``PagedEngine``
(``paged_engine.pick_greedy``), fp32 on the CPU at a tiny dense size
(vocab 64, padded to 2048 columns):

  * token for token, the engine's tokens equal the host path's, where every
    sampled row's logits come to the host as fp32 and are argmaxed there
    by ``sampler.sample`` (and ``argmax(axis=-1)`` over a verify window):
    K = 1 decode, the spec K = 5 window, packed and batch-1 prefill rows,
    recompute preemption, and a tp=2 engine over gloo;
  * garbage planted in the padded vocab columns is never picked, and an
    exact tie goes to the lowest index, as ``np.argmax`` takes it, in the
    engine and in ``pick_greedy`` alone (fp32 and bf16);
  * a batch mixing greedy and ``temperature > 0`` rows serves the host
    path's tokens, and only the sampled rows' logits reach the host;
  * ``sampled_rows_device`` + ``sampled_rows_host`` counts every sampled
    row: each prompt-finishing grant and each decoding row of a step."""
import numpy as np
import pytest
import torch

from conftest import tiny_dense
from repro_torch.config import Config, ISOConfig, ModelConfig, \
    ParallelConfig, ServingConfig
from repro_torch.launch import mesh
from repro_torch.models import api
from repro_torch.serving import PagedEngine, Request, paged_engine
from repro_torch.serving.requests import SamplingParams
from repro_torch.serving.sampler import sample

torch.set_num_threads(1)

CFG = ModelConfig(**{f: getattr(tiny_dense(vocab_size=64), f) for f in (
    "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
    "d_ff", "vocab_size", "qk_norm")})
V = CFG.vocab_size
ISO = ISOConfig(enabled=True, num_chunks=2, min_chunk_tokens=8, chunk_align=8)
GREEDY = SamplingParams(temperature=0.0)
# traffic: (prompt lengths, serving settings)
CASES = {
    "decode_k1": ((40, 25, 70, 9), dict(max_batch=4,
                                        prefill_token_budget=64)),
    "spec_k5": ((40, 25, 70, 9, 33), dict(max_batch=4, spec_k=4,
                                          prefill_token_budget=32)),
    "packed": ((40, 25, 70, 9, 33), dict(max_batch=4,
                                         prefill_token_budget=32)),
    "batch1": ((40, 25, 70, 9, 33), dict(max_batch=4,
                                         prefill_token_budget=32,
                                         prefill_batching=False)),
    "preempt": ((30, 33, 29, 41), dict(max_batch=2, num_pages=8, spec_k=2,
                                       prefill_token_budget=24)),
}


def _engine(params, mesh_group=None, **sv):
    sv = dict(dict(page_size=8, max_len=160), **sv)
    tp = mesh_group.tp if mesh_group is not None else 1
    return PagedEngine(Config(model=CFG,
                              parallel=ParallelConfig(data=1, model=tp),
                              iso=ISO, serving=ServingConfig(**sv)),
                       params, mesh=mesh_group,
                       device=None if mesh_group is not None else "cpu")


def _serve(eng, lengths, new=8, hot=()):
    """Serve the case's prompts (a repeated pattern, so the self-draft
    hits); the requests in ``hot`` sample at temperature 0.8."""
    rng = np.random.default_rng(3)
    for i, n in enumerate(lengths):
        base = rng.integers(2, V, 5).astype(np.int32)
        eng.add_request(Request(prompt=np.resize(base, n), rid=i,
                                sampling=SamplingParams(
                                    max_new_tokens=new, eos_id=-1, seed=i,
                                    temperature=0.8 if i in hot else 0.0)))
    out = eng.run_until_complete()
    return [out[i] for i in range(len(lengths))]


def host_pick(logits, vocab):
    """The host path: the gathered logits to the host as fp32, each row
    argmaxed over the vocab's columns by the host sampler."""
    full = logits.float().cpu().numpy()                # (..., V_pad)
    flat = full.reshape(-1, full.shape[-1])
    ids = [sample(r[:vocab], GREEDY, 0) for r in flat]
    return torch.tensor(ids, dtype=torch.int32).reshape(full.shape[:-1])


class HostPath:
    """While active, every sampled row goes the host path: its logits are
    copied and ``sample`` picks its token (``_on_host``), and a verify
    window's ids are the host's argmaxes (``host_pick``)."""

    def __enter__(self):
        self.orig = paged_engine.pick_greedy, paged_engine._on_host
        paged_engine.pick_greedy = host_pick
        paged_engine._on_host = lambda sp: True
        return self

    def __exit__(self, *exc):
        paged_engine.pick_greedy, paged_engine._on_host = self.orig
        return False


@pytest.fixture(scope="module")
def params():
    return api.init_params(0, CFG, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def runs(params):
    """case -> (device engine, device tokens, host tokens), served once."""
    cache = {}

    def get(case):
        if case not in cache:
            lengths, sv = CASES[case]
            eng = _engine(params, **sv)
            toks = _serve(eng, lengths)
            with HostPath():
                host = _serve(_engine(params, **sv), lengths)
            cache[case] = (eng, toks, host)
        return cache[case]
    return get


def _tp_rank_job(group, lengths, sv):
    """A tp=2 rank: this rank's shard of the weights, served on the device
    path and on the host path."""
    params = api.init_params(0, CFG, tp=group.tp, dtype=torch.float32,
                             device="cpu", rank=group.rank)
    eng = _engine(params, group, **sv)
    toks = _serve(eng, lengths)
    with HostPath():
        host = _serve(_engine(params, group, **sv), lengths)
    return toks, host, eng.metrics["sampled_rows_device"]


@pytest.mark.parametrize("case", sorted(CASES) + ["tp2"])
def test_device_greedy_equals_host_path(runs, case):
    if case == "tp2":
        lengths, sv = CASES["spec_k5"]
        ranks = mesh.spawn(_tp_rank_job, 2, args=(lengths, sv),
                           device="cpu", timeout_s=300)
        for toks, host, n_dev in ranks:
            assert toks == host == ranks[0][0]
            assert n_dev > 0
        return
    eng, toks, host = runs(case)
    m = eng.metrics
    assert toks == host
    assert all(0 <= t < V for t in sum(toks, []))
    assert m["sampled_rows_host"] == 0 and m["sampled_rows_device"] > 0
    assert (m["spec_calls"] > 0) == (case in ("spec_k5", "preempt"))
    if case == "spec_k5":
        assert eng.decode_splits and 5 in {k for k, _ in eng._decode_fns}
    if case == "packed":
        assert m["prefill_calls"] < m["prefill_grants"]
    if case == "batch1":
        assert m["prefill_calls"] == m["prefill_grants"]
    if case == "preempt":
        assert m["preemptions"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampled_row_counters_add_up(runs, case):
    eng, toks, _ = runs(case)
    m = eng.metrics
    decode_rows = sum(1 for e in eng.trace.events() if e.kind == "accept")
    assert eng.trace.dropped == 0
    assert m["sampled_rows_device"] + m["sampled_rows_host"] == \
        m["prefill_samples"] + decode_rows
    if not m["spec_calls"] and not m["preemptions"]:
        # one sampled row a token
        assert m["sampled_rows_device"] == sum(map(len, toks))


def _plant(kind):
    """A gather that plants ``kind`` into the gathered logits: ``garbage``,
    the dtype's largest value in every padded column; ``tie``, one value
    above the row's maximum at columns 3, 7 and 40."""
    gather = paged_engine.all_gather_last

    def planted(x, ctx):
        out = gather(x, ctx).clone()
        if kind == "garbage":
            out[..., V:] = torch.finfo(out.dtype).max
        else:
            top = out[..., :V].amax(-1, keepdim=True) + 1
            out[..., [3, 7, 40]] = top.expand(*top.shape[:-1], 3)
        return out
    return planted


@pytest.mark.parametrize("kind", ["garbage", "tie"])
def test_planted_logits(params, monkeypatch, kind):
    lengths, sv = CASES["spec_k5"]
    clean = _serve(_engine(params, **sv), lengths)
    monkeypatch.setattr(paged_engine, "all_gather_last", _plant(kind))
    toks = _serve(_engine(params, **sv), lengths)
    with HostPath():
        host = _serve(_engine(params, **sv), lengths)
    assert toks == host
    if kind == "garbage":
        assert toks == clean
    else:
        assert all(t == 3 for t in sum(toks, []))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_pick_greedy_ties_and_padding(dtype):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 2, 128, generator=g).to(dtype)   # (B, K, V_pad)
    logits[0, 0, [5, 9, 40]] = 50
    logits[1, 1, [0, 63]] = 50
    logits[2, :, [17, 18]] = 50
    logits[3, :, V:] = 1e4                  # the padding above every column
    logits[3, 1, V - 1] = 60
    ids = paged_engine.pick_greedy(logits, V)
    assert ids.dtype == torch.int32 and ids.shape == (4, 2)
    want = np.argmax(logits.float().numpy()[..., :V], axis=-1)
    assert ids.tolist() == want.tolist()
    assert ids[0, 0] == 5 and ids[1, 1] == 0 and ids[2].tolist() == [17, 17]
    assert ids[3, 1] == V - 1 and (ids < V).all()
    assert paged_engine.pick_greedy(logits[:, 0], V).tolist() == \
        ids[:, 0].tolist()


def test_mixed_batch_samples_only_hot_rows_on_host(params, monkeypatch):
    """Requests 1 and 3 sample at temperature 0.8, the rest are greedy."""
    lengths, sv = CASES["packed"]
    hot = (1, 3)
    with HostPath():
        before = _serve(_engine(params, spec_k=2, **sv), lengths, hot=hot)
    fetched = []
    fetch = PagedEngine._fetch

    def spy(self, picks):
        rows, _, host_rows, logits = picks
        fetched.append((len(rows), len(host_rows),
                        None if logits is None else tuple(logits.shape)))
        if logits is not None and logits.dim() == 3:      # a decode step
            assert all(self.slots[i].request.sampling.temperature > 0
                       for i in host_rows)
        return fetch(self, picks)

    monkeypatch.setattr(PagedEngine, "_fetch", spy)
    eng = _engine(params, spec_k=2, **sv)
    toks = _serve(eng, lengths, hot=hot)
    m = eng.metrics
    assert toks == before
    n_hot = sum(len(toks[i]) for i in hot)
    assert m["sampled_rows_host"] == n_hot > 0
    decode_rows = sum(1 for e in eng.trace.events() if e.kind == "accept")
    assert m["sampled_rows_device"] + n_hot == \
        m["prefill_samples"] + decode_rows
    assert sum(h for _, h, _ in fetched) == n_hot
    for n, h, shape in fetched:
        # no logits copied without a hot row; a hot row's copy holds only
        # the vocab's columns
        assert (shape is None) == (h == 0)
        assert shape is None or (shape[0] == h and shape[-1] == V)
    assert any(shape is None for *_, shape in fetched)
    assert m["spec_calls"] > 0            # once the hot requests are done
