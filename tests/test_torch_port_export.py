"""The port's serving artifact (``tmar_torch.export``) against the JAX
package's (``tmar.export``), on the CPU at float32; the ``.pth`` export and
the discriminator import.

* One tiny NGswin (``TINY`` of tests/test_export.py): the port draws its
  weights from a seed, ``tmar.checkpoint.import_ngswin_state_dict`` makes
  them a flax tree, JAX's ``save_pth`` writes that tree as a ``.pth`` and
  ``from_flax_params`` carries it into the port's models.
* ``tmar.cli export`` and ``tmar_torch.cli export --device cpu`` turn the
  ``.pth`` into an artifact each, 2x64².  The port's (the map form) and the
  port's own exports of the token, unfused and composition forms, saved and
  loaded back, each equal that form's eager forward bit for bit and agree
  with JAX's artifact within atol 5e-5, rtol 1e-4, the JAX package's
  model-level tolerance.  A wrong batch raises.  After the exports the
  constant cache holds no fake tensor and the eager forward is unchanged.
* ``export --torch`` of both packages: the same keys, exactly the same
  values.
* ``disc_from_pth`` against ``disc_from_flax`` on a reference-layout
  discriminator ``state_dict`` that the JAX package's importer maps to the
  flax tree it was written from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

import tmar.cli as jcli
from tmar.checkpoint import import_discriminator_state_dict, import_ngswin_state_dict
from tmar.checkpoint import save_pth as jax_save_pth
from tmar.export import load_artifact as jax_load_artifact
from tmar.nn import MultiScaleDiscriminator as FlaxDiscriminator
from tmar_torch import NGswin, cli
from tmar_torch.checkpoint import disc_from_flax, disc_from_pth, from_flax_params, load_pth
from tmar_torch.export import _changes_nothing, export_generator, load_artifact, save_artifact
from tmar_torch.nn import MultiScaleDiscriminator
from tmar_torch.ops import attention
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=5e-5, rtol=1e-4)
TINY = dict(
    ngrams=(2, 2, 2, 2), embed_dim=32, depths=(1, 1, 1), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=1, dec_num_heads=2, window_size=8,
)
# TINY as config overrides, at float32: both CLIs take them as written
SETS = [
    "model.embed_dim=32", "model.depths=[1,1,1]", "model.num_heads=[2,2,2]", "model.dec_dim=32",
    "model.dec_depths=1", "model.dec_num_heads=2", "bf16=false",
]
# NGswin keywords of each block form
FORMS = {
    "map": {},
    "tokens": {"nstb_map": False},
    "unfused": {"nstb_fused": False},
    "composition": {"ngram_fused": False},
}


def _model(params, form):
    model = NGswin(**TINY, device="cpu", **FORMS[form]).eval()
    model.load_state_dict(from_flax_params(params))
    return model


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Both CLIs' artifacts and ``--torch`` files from one ``.pth``, the
    eager outputs of every form (taken before any export in this process)
    and the JAX artifact's output."""
    d = tmp_path_factory.mktemp("export")
    torch.manual_seed(0)
    sd = NGswin(**TINY, device="cpu").state_dict()
    params = import_ngswin_state_dict({k: v.numpy() for k, v in sd.items()})
    pth = str(d / "tiny.pth")
    jax_save_pth(params, pth)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    with torch.no_grad():
        eager = {f: _model(params, f)(torch.from_numpy(x)) for f in FORMS}
    files = {k: str(d / k) for k in ("jax.tmarx", "port.pt2", "jax.pth", "port.pth")}
    common = ["--checkpoint", pth, "--batch", "2", "--size", "64", "--set", *SETS]
    assert jcli.main(["export", *common, "--out", files["jax.tmarx"]]) == 0
    assert jcli.main(["export", *common, "--torch", "--out", files["jax.pth"]]) == 0
    port = [*common, "--device", "cpu"]
    assert cli.main(["export", *port, "--out", files["port.pt2"]]) == 0
    assert cli.main(["export", *port, "--torch", "--out", files["port.pth"]]) == 0
    return dict(params=params, x=x, eager=eager, files=files, dir=d,
                jax_out=np.asarray(jax_load_artifact(files["jax.tmarx"])(x)),
                port_fn=load_artifact(files["port.pt2"]))


@pytest.mark.parametrize("form", list(FORMS))
def test_artifact_round_trip_equals_eager_and_matches_jax(exported, form):
    """The map form is the port CLI's artifact; the others are exported
    here.  Reloaded: bit for bit the eager forward, and JAX's artifact
    within the model tolerance."""
    fn = exported["port_fn"]
    if form != "map":
        path = str(exported["dir"] / f"{form}.pt2")
        save_artifact(path, export_generator(_model(exported["params"], form), batch=2, size=64,
                                             device="cpu"))
        fn = load_artifact(path)
    got = fn(exported["x"])
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, exported["eager"][form])
    np.testing.assert_allclose(got.numpy(), exported["jax_out"], **TOL)


def test_artifact_rejects_another_batch(exported):
    with pytest.raises(Exception, match="Guard failed"):
        exported["port_fn"](np.zeros((1, 64, 64, 1), np.float32))  # wrong batch bucket


def test_export_caches_no_fake_tensor_and_leaves_eager_unchanged(exported):
    """The fixture's export traced the forward after an eager one had
    filled the constant cache."""
    cached = [t for _, tensors in attention._const_cache.values() for t in tensors.values()]
    assert cached and not any(isinstance(t, FakeTensor) for t in cached)
    with torch.no_grad():
        again = _model(exported["params"], "map")(torch.from_numpy(exported["x"]))
    assert torch.equal(again, exported["eager"]["map"])


def test_torch_pth_export_matches_jax(exported):
    """``export --torch``: the same keys and exactly the same values as the
    JAX CLI's, which ``load_pth`` reads back into the port's model."""
    files = exported["files"]
    ref = torch.load(files["jax.pth"], weights_only=True)["netG_state_dict"]
    got = torch.load(files["port.pth"], weights_only=True)["netG_state_dict"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    NGswin(**TINY, device="cpu").load_state_dict(load_pth(files["port.pth"]))


@pytest.mark.parametrize("args,kwargs,skipped", [
    ((torch.float32,), {}, True), (("cpu",), {}, True), (("cpu", torch.float32), {}, True),
    ((), {"device": "cpu", "dtype": torch.float32}, True), ((torch.bfloat16,), {}, False),
    ((), {"dtype": torch.float32, "copy": True}, False), ((torch.zeros(1),), {}, False),
    ((), {}, False),
])
def test_export_drops_only_the_casts_that_change_nothing(args, kwargs, skipped):
    assert _changes_nothing(torch.zeros(2), args, kwargs) is skipped


def test_cli_export_refuses_the_tpu():
    with pytest.raises(SystemExit, match="tpu"):
        cli.main(["export", "--checkpoint", "x.pth", "--platform", "tpu"])


def _reference_layout(params, sn):
    """The reference ``state_dict`` of a flax discriminator tree: the
    inverse of ``import_discriminator_state_dict``'s names, spectral-norm
    convs as weight_orig / weight_u / weight_v, kernels [out, in, kh, kw]."""

    def name(path):
        out = []
        for p in path:
            stem, _, i = p.rpartition("_")
            out.append({"discriminators": f"discriminators.{i}", "conv": f"convs.{i}"}.get(stem, p))
        return ".".join(out)

    sd = {}
    for path, v in _leaves(params):
        if path[-1] == "kernel":
            sd[f"{name(path[:-1])}.weight_orig"] = torch.from_numpy(v.transpose(3, 2, 0, 1).copy())
        else:
            sd[f"{name(path[:-1])}.{path[-1]}"] = torch.from_numpy(v.copy())
    for path, v in _leaves(sn):
        sd[f"{name(path[:-1])}.weight_{path[-1]}"] = torch.from_numpy(v.copy())
    return sd


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_disc_from_pth_matches_disc_from_flax(tmp_path):
    x = jnp.zeros((1, 64, 64, 2), jnp.float32)
    shapes = jax.eval_shape(FlaxDiscriminator(base_channels=8, num_scales=2).init,
                            jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(3)

    params, sn = (jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), shapes[c]) for c in ("params", "sn"))
    ref = _reference_layout(params, sn)
    assert any(k.endswith("convs.1.weight_orig") for k in ref)
    # the JAX importer maps the layout back to the tree it was written from
    got_params, got_sn = import_discriminator_state_dict(ref)
    for tree, back in ((params, got_params), (sn, got_sn)):
        assert dict(_leaves(tree)).keys() == dict(_leaves(back)).keys()
        for p, v in _leaves(tree):
            np.testing.assert_array_equal(dict(_leaves(back))[p], v)
    want = disc_from_flax(params, sn)
    torch.save({"netD_state_dict": {f"module.{k}": v for k, v in ref.items()}}, tmp_path / "d.pth")
    for got in (disc_from_pth(ref), disc_from_pth(str(tmp_path / "d.pth"))):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    MultiScaleDiscriminator(base_channels=8, num_scales=2, device="cpu").load_state_dict(got)
