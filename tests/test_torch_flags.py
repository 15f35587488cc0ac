"""The port's command line (gslora_tpu_torch/config.build_parser) against
the JAX package's (gslora_tpu/config.build_parser): every action with the
same option strings, dest, default, type, choices, nargs, const and
action class, in the same order. The port's ``--device`` is the one
extra. Run under ``JAX_PLATFORMS=cpu``."""
import argparse
import json

import gslora_tpu.config as jc
import gslora_tpu_torch.config as tc

EXTRA = {"device"}  # RunConfig.device: where the port runs


def _surface(parser):
    """dest -> what the parser does with the flag (help text aside)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = dict(
            option_strings=tuple(a.option_strings), default=a.default,
            type=getattr(a.type, "__name__", a.type),
            choices=None if a.choices is None else list(a.choices),
            nargs=a.nargs, const=a.const, required=a.required,
            action=type(a).__name__)
    return out


def test_every_flag_matches_jax():
    """Each of JAX's actions has its twin in the port, field by field,
    and the port's actions come in JAX's order."""
    want, got = _surface(jc.build_parser()), _surface(tc.build_parser())
    assert len(want) > 100
    for dest, spec in want.items():
        assert dest in got, dest
        assert got[dest] == spec, (dest, got[dest], spec)
    assert [d for d in got if d not in EXTRA] == list(want)


def test_device_is_the_only_extra():
    """The port adds --device (default cuda: its entry points run on the
    card unless asked for the CPU) and nothing else."""
    want, got = _surface(jc.build_parser()), _surface(tc.build_parser())
    assert set(got) - set(want) == EXTRA
    assert got["device"]["option_strings"] == ("--device",)
    assert got["device"]["default"] == "cuda"


def test_defaults_parse_alike():
    """No arguments: the two namespaces hold the same values, and so do
    the run configs built from them."""
    jns, tns = jc.build_parser().parse_args([]), \
        tc.build_parser().parse_args([])
    targs = dict(vars(tns))
    assert targs.pop("device") == "cuda"
    assert targs == vars(jns)
    jcfg = json.loads(jc.config_from_args(jns).to_json())
    tcfg = json.loads(tc.config_from_args(tns).to_json())
    assert tcfg.pop("device") == "cuda"
    assert tcfg == jcfg
