"""The port's mesh (``parallel/mesh.py``) and collectives
(``parallel/collectives.py``) on the CPU.

The Megatron rule tables, ``family_tp_fns``'s kinds and the GPT-2 c_attn
permutation against the JAX package's (``bayeformers_tpu/parallel/
mesh.py``) on every parameter path of BERT, DistilBERT, ALBERT, ViT, GPT-2,
LLaMA and T5 (the port's paths are the Flax ones); a spec is the
reference's ``PartitionSpec`` as a plain tuple. Then, two or four ranks as
threads over gloo (``tests/torch_ranks.py``): the rank layout ``d * tp +
t`` and its groups, the f and g collectives forward and backward,
``replicate``, shard and unshard, and a checkpoint written by rank 0 from
tp shards and read back by one process and by the ranks.
"""
import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.traverse_util import unflatten_dict

import bayeformers_tpu_torch as bt
from bayeformers_tpu.nn.surgery import BayesParams
from bayeformers_tpu.parallel import mesh as jmesh
from bayeformers_tpu_torch.parallel import collectives as coll
from bayeformers_tpu_torch.parallel import mesh as mesh_lib
from bayeformers_tpu_torch.parallel import train as ptrain
from bayeformers_tpu_torch.utils import checkpoint as ckpt
from torch_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

F32 = dict(device="cpu", dtype=torch.float32)
FAMILIES = {
    "bert": lambda: bt.build_model("bert-base-uncased", size="tiny", **F32),
    "distilbert": lambda: bt.build_model("distilbert-base-uncased", size="tiny", **F32),
    "albert": lambda: bt.build_model("albert-base-v2", size="tiny", **F32),
    "vit": lambda: bt.build_vit(size="tiny", **F32),
    "gpt2": lambda: bt.build_gpt2(size="tiny", **F32),
    "llama": lambda: bt.build_llama_family("llama", size="tiny", **F32),
    "t5": lambda: bt.build_t5(size="tiny", **F32),
}
SPEC_PAIRS = ((mesh_lib.tp_param_spec, jmesh.tp_param_spec),
              (mesh_lib.gpt2_param_spec, jmesh.gpt2_param_spec),
              (mesh_lib.llama_param_spec, jmesh.llama_param_spec),
              (mesh_lib.t5_param_spec, jmesh.t5_param_spec))


def _paths(net):
    return [n.replace(".", "/") for n, _ in net.named_parameters()]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rule_tables_and_kinds_match_jax(family):
    net = FAMILIES[family]()
    paths = _paths(net)
    converted = bt.to_bayesian(net, delta=0.05, freeze=True).spec.paths
    for port_fn, jax_fn in SPEC_PAIRS:
        for p in paths:
            assert port_fn(p) == tuple(jax_fn(p)), (port_fn.__name__, p)
    for p in paths:
        assert mesh_lib.tp_kind(p) == jmesh.tp_kind(p), p
        assert mesh_lib.gpt2_tp_kind(p) == jmesh.gpt2_tp_kind(p), p
    spec_fn, kind_fn, ok = mesh_lib.family_tp_fns(converted)
    jspec_fn, jkind_fn, jok = jmesh.family_tp_fns(converted)
    assert ok == jok == (family != "t5")
    sharded = 0
    for p in converted:
        assert spec_fn(p) == tuple(jspec_fn(p)), p
        assert kind_fn(p) == jkind_fn(p), p
        sharded += kind_fn(p) != "rep"
    assert sharded > 0
    mesh_lib.assert_tp_coverage(converted, spec_fn)


def test_kind_from_spec_and_coverage_match_jax():
    P = jmesh.P
    for spec in (P(None, "tp"), P("tp"), P("tp", None), P()):
        assert mesh_lib.kind_from_spec(tuple(spec)) == jmesh.kind_from_spec(spec)
    with pytest.raises(ValueError, match="no converted parameter path"):
        mesh_lib.assert_tp_coverage(["classifier/kernel", "pooler/dense/kernel"])


@pytest.mark.parametrize("E,tp", [(8, 2), (12, 3), (768, 2), (768, 4), (64, 1)])
def test_qkv_perm_matches_jax(E, tp):
    np.testing.assert_array_equal(mesh_lib._qkv_perm(E, tp), jmesh._qkv_perm(E, tp))


def test_permute_gpt2_qkv_matches_jax_and_round_trips():
    bmodel = bt.to_bayesian(FAMILIES["gpt2"](), delta=0.05)  # trainable mu: prior_mu a copy
    state = {part: {p: t.detach().clone() for p, t in ts.items()}
             for part, ts in ckpt.variational_state(bmodel).items()}
    jbp = BayesParams(
        params=unflatten_dict({tuple(p.split("/")): t.numpy() for p, t in state["params"].items()}),
        rho={p: t.numpy() for p, t in state["rho"].items()},
        prior_mu={p: t.numpy() for p, t in state["prior_mu"].items()})
    jperm = jmesh.permute_gpt2_qkv(jbp, 2)
    mesh_lib.permute_gpt2_qkv(bmodel, 2)
    got = ckpt.variational_state(bmodel)
    jflat = {"/".join(k): v for k, v in __import__("flax").traverse_util.flatten_dict(
        jperm.params).items()}
    for part, want in (("params", jflat), ("rho", jperm.rho), ("prior_mu", jperm.prior_mu)):
        for p, w in want.items():
            np.testing.assert_array_equal(got[part][p].detach().numpy(), np.asarray(w),
                                          err_msg=f"{part} {p}")
    assert any("c_attn" in p for p in jperm.rho)
    mesh_lib.permute_gpt2_qkv(bmodel, 2, inverse=True)
    back = ckpt.variational_state(bmodel)
    for part in state:
        for p, t in state[part].items():
            assert torch.equal(back[part][p].detach(), t), (part, p)


def test_make_mesh_layout_and_refusals():
    """Rank d * tp + t: its dp group holds the ranks of tp coordinate t, its
    tp group those of dp coordinate d."""
    def rank(r, mesh):
        assert (mesh.dp_rank, mesh.tp_rank) == divmod(r, 2)
        a = coll.all_reduce_(torch.tensor([float(r)]), mesh.dp_group)
        b = coll.all_reduce_(torch.tensor([float(r)]), mesh.tp_group)
        w = coll.all_reduce_(torch.tensor([1.0]), mesh.world_group)
        return float(a), float(b), float(w)

    res = run_ranks(2, 2, rank)
    assert res == [(2.0, 1.0, 4.0), (4.0, 1.0, 4.0), (2.0, 5.0, 4.0), (4.0, 5.0, 4.0)]
    store = dist.HashStore()
    with pytest.raises(NotImplementedError, match=r"item 6\(d\)"):
        mesh_lib.make_mesh(1, 1, sp=2, backend="gloo", store=store, rank=0, world_size=1)
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 2"):
        mesh_lib.make_mesh(2, 2, backend="gloo", store=store, rank=0, world_size=2)
    assert mesh_lib.make_mesh(0, 1, backend="gloo", store=store, rank=0, world_size=1).dp == 1
    with pytest.raises(ValueError, match="gloo groups only"):
        mesh_lib.make_mesh(1, 1, backend="nccl", store=store, rank=0, world_size=1)


def test_copy_to_shards_and_reduce_from_shards():
    """f: identity forward, all-reduce backward; g: all-reduce forward,
    identity backward (16-bit inputs summed in f32)."""
    def rank(r, mesh):
        x = torch.full((3,), float(r + 1), requires_grad=True)
        y = coll.copy_to_shards(x, mesh.tp_group)
        (y * (r + 2)).sum().backward()
        xg = torch.full((3,), float(r + 1), requires_grad=True)
        z = coll.reduce_from_shards(xg * 2.0, mesh.tp_group)
        (z * (r + 1)).sum().backward()
        h = coll.reduce_from_shards(torch.full((2,), 1.0 + r / 256, dtype=torch.bfloat16),
                                    mesh.tp_group)
        return y.detach(), x.grad, z.detach(), xg.grad, h

    (y0, gx0, z0, g0, h0), (y1, gx1, z1, g1, h1) = run_ranks(1, 2, rank)
    assert torch.equal(y0, torch.full((3,), 1.0)) and torch.equal(y1, torch.full((3,), 2.0))
    assert torch.equal(gx0, torch.full((3,), 5.0)) and torch.equal(gx1, gx0)  # 2 + 3
    assert torch.equal(z0, torch.full((3,), 6.0)) and torch.equal(z1, z0)     # 2 + 4
    assert torch.equal(g0, torch.full((3,), 2.0)) and torch.equal(g1, torch.full((3,), 4.0))
    assert h0.dtype == torch.bfloat16 and torch.equal(h0, h1)
    assert float(h0[0]) == float(torch.tensor(2.0 + 1 / 256).to(torch.bfloat16))


def test_replicate_shard_unshard_and_checkpoint(tmp_path):
    """Rank 0's state on every rank; the tp shards of GPT-2 (c_attn
    permuted) gathered whole; a checkpoint written by rank 0 holds the stock
    layout, reloads in one process and re-shards on the ranks."""
    bmodel = bt.to_bayesian(FAMILIES["gpt2"](), delta=0.05, freeze=True)
    whole = {part: {p: t.detach().clone() for p, t in ts.items()}
             for part, ts in ckpt.variational_state(bmodel).items()}

    def rank(r, mesh):
        bm = copy.deepcopy(bmodel)
        if r == 1:  # a replica that drifted: replicate takes rank 0's
            with torch.no_grad():
                for t in bm.rho.values():
                    t.add_(1.0)
        ptrain.prepare_bayes_params(bm, mesh)
        c = "transformer/h/0/attn/c_attn/kernel"
        assert bm.rho[c].shape[0] == bmodel.rho[c].shape[0] // 2
        gathered = mesh_lib.unshard_bayes_params(bm, mesh)
        ckpt.save_checkpoint(str(tmp_path), bm, step=1, mesh=mesh)
        again = copy.deepcopy(bmodel)
        ptrain.prepare_bayes_params(again, mesh)
        with torch.no_grad():
            for t in again.rho.values():
                t.zero_()
        ckpt.load_checkpoint(str(tmp_path), again, step=1, mesh=mesh)
        return gathered, mesh_lib.unshard_bayes_params(again, mesh)

    for gathered, reloaded in run_ranks(1, 2, rank):
        stock = mesh_lib.permute_gpt2_qkv(gathered, 2, inverse=True)
        for part in whole:
            for p, t in whole[part].items():
                assert torch.equal(stock[part][p], t), (part, p)
                assert torch.equal(reloaded[part][p], gathered[part][p]), (part, p)
    one = bt.to_bayesian(FAMILIES["gpt2"](), delta=0.05, freeze=True)
    ckpt.load_checkpoint(str(tmp_path), one, step=1)
    for part, ts in ckpt.variational_state(one).items():
        for p, t in ts.items():
            assert torch.equal(t.detach(), whole[part][p]), (part, p)
