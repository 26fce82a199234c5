"""The port's configuration tree and ``parse_cli`` against nf_tpu's, on
the CPU: ``to_dict`` of every network's defaults and of typed overrides
(bool, None, int, float, str) equal, the same ``ValueError``s, and
``run.platform`` as the device."""
import pytest

from nf_tpu import config as jconfig
from nf_tpu_torch import config


def test_defaults_are_nf_tpus():
    assert config.to_dict(config.Config()) == jconfig.to_dict(jconfig.Config())
    assert config.NETWORK_DEFAULTS == jconfig.NETWORK_DEFAULTS
    for cls in ("NetworkConfig", "TrainConfig", "OptimizerConfig", "RunConfig", "Config"):
        ours = [f.name for f in config.dataclasses.fields(getattr(config, cls))]
        assert ours == [f.name for f in jconfig.dataclasses.fields(getattr(jconfig, cls))]


OVERRIDES = [
    ["train.steps=7", "train.samples=64", "train.chunk=2"],
    ["run.debug=true", "run.dequantize=False", "run.save_all_reports=TRUE"],
    ["run.ckpt_path=none", "run.resume=auto", "network.rtol=null", "network.atol=1e-3"],
    ["optimizer.lr=3e-3", "optimizer.name=rmsprop", "optimizer.weight_decay=0",
     "optimizer.beta2=0.99"],
    ["run.distrib=mnist16", "run.display=0.01", "run.seed=-3", "run.data_root=/x=y",
     "network.layers=4", "network.base_filters=8", "network.scan=true",
     "network.compute_dtype=bfloat16", "network.matmul_precision=float32"],
    ["run.platform=cpu", "run.output=1.5e2"],
]


@pytest.mark.parametrize("network", sorted(config.NETWORK_DEFAULTS))
@pytest.mark.parametrize("overrides", range(len(OVERRIDES)))
def test_parse_cli_is_nf_tpus(network, overrides):
    argv = OVERRIDES[overrides] + [f"network={network}"]
    got = config.to_dict(config.parse_cli(argv))
    want = jconfig.to_dict(jconfig.parse_cli(argv))
    assert got == want
    # the values keep their coerced types
    assert [type(v) for v in got["train"].values()] == \
        [type(v) for v in want["train"].values()]
    assert got["network"]["name"] == network


@pytest.mark.parametrize("argv", [["network=nice"], ["train.steps"], ["train.epochs=3"],
                                  ["run.nope=1"]])
def test_parse_cli_errors_are_nf_tpus(argv):
    with pytest.raises(ValueError) as want:
        jconfig.parse_cli(argv)
    with pytest.raises(ValueError) as got:
        config.parse_cli(argv)
    assert str(got.value) == str(want.value)


def test_bad_group_raises_as_nf_tpu():
    for mod in (config, jconfig):
        with pytest.raises(AttributeError):
            mod.parse_cli(["nothing.steps=1"])


def test_platform_is_the_device():
    assert config.platform_device(None) is None
    assert config.platform_device("cuda") is None
    assert config.platform_device("cpu") == "cpu"
    with pytest.raises(ValueError, match="run.platform"):
        config.platform_device("tpu")
