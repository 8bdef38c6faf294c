"""The port's YAML config system (``rise_sdf_tpu_torch/config.py`` and
``utils/yamlio.py``) against the JAX package's
``rise_sdf_tpu.config.load_config`` and PyYAML.

``load_config`` on the three yamls of ``configs/``, without and with
dotlists (YAML 1.1 scalars, keys the file lacks, the resolvers, nested
references, ``extra``), compared as primitives with types kept (``True``
is not ``1``); a ``???`` left unset and a cycle behave as in JAX.  The
reader equals ``yaml.safe_load`` on every document ``yaml.safe_dump``
writes from generated data (block and flow styles, narrow widths that
fold long scalars over lines, indents, unicode or escapes, document
markers), and the writer's output reads back equal with both readers.
Outside the subset the reader raises naming the line."""

import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rise_sdf_tpu import config as jconfig
from rise_sdf_tpu_torch import config
from rise_sdf_tpu_torch.utils import yamlio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["neus-blender.yaml", "split-mixed-occ-tensoir.yaml",
         "split-smoke.yaml"]
# YAML 1.1 scalars as PyYAML's SafeLoader types them, keys the files
# lack (merged in), flow collections, an empty value
YAML11 = ["system.optimizer.args.lr=1e-3", "system.optimizer.args.eps=1.0e-3",
          "model.radius=.5", "trainer.max_steps=1_000", "seed=0x10",
          "tag=010", "model.grid_prune=yes", "model.randomized=on",
          "model.new_key.sub=True", "name=~", "export.chunk_size=null",
          "dataset.img_wh=[64, 64]", "dataset.extra={a: 1, b: [x, 2.5]}",
          "trainer.val_check_interval=", "checkpoint.note='1e-3'",
          "model.when=2024-01-05", "model.neg=-.inf"]
RESOLVERS = ["r.exp=${calc_exp_lr_decay_rate:0.1,100}", "r.add=${add:1,2.5}",
             "r.sub=${sub:${trainer.max_steps},10}", "r.mul=${mul:2,3}",
             "r.div=${div:1,4}", "r.idiv=${idiv:7,2}",
             "r.base=${basename:/a/b/c.txt}", "r.whole=${model.radius}",
             "r.part=r${model.radius}/${trainer.max_steps}",
             "r.nested=${r.whole}", "r.deep=${add:${r.whole},${r.mul}}"]
DOTLISTS = {"none": [], "scene": ["dataset.scene=lego"],
            "yaml11": ["dataset.scene=lego"] + YAML11,
            "resolvers": ["dataset.scene=x"] + RESOLVERS,
            "unset": YAML11}


def same(a, b):
    """Equal with types kept (``True`` is not ``1``, ``1`` not ``1.0``)
    and nan equal to nan."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("dotlist", sorted(DOTLISTS))
@pytest.mark.parametrize("name", YAMLS)
def test_load_config_equals_jax(name, dotlist):
    path = os.path.join(REPO, "configs", name)
    cli = DOTLISTS[dotlist]
    got = config.load_config(path, cli_args=cli)
    want = jconfig.load_config(path, cli_args=cli)
    assert isinstance(got, config.ConfigNode)
    assert same(config.config_to_primitive(got),
                jconfig.config_to_primitive(want))
    if "scene" in got["dataset"] and dotlist in ("none", "unset"):
        # ``???`` is left in place, and reading it raises, in both
        assert got["dataset"]["scene"] == "???"
        for node in (got.dataset, want.dataset):
            with pytest.raises(ValueError, match="scene"):
                node.get("scene")
            with pytest.raises(ValueError, match="scene"):
                node.scene


def test_extra_merges_last_and_files_merge_in_order():
    paths = [os.path.join(REPO, "configs", n) for n in YAMLS[:2]]
    extra = {"trainer": {"max_steps": 7}, "added": [1, {"b": None}]}
    cli = ["dataset.scene=s", "trainer.max_steps=9"]
    got = config.load_config(*paths, cli_args=cli, extra=extra)
    want = jconfig.load_config(*paths, cli_args=cli, extra=extra)
    assert same(got.to_primitive(), want.to_primitive())
    assert got.trainer.max_steps == 7


@pytest.mark.parametrize("cli", [["a=${b}", "b=${a}"],
                                 ["model.radius=${model.radius}"],
                                 ["a=${add:${a},1}"]])
def test_a_cycle_raises(cli):
    path = os.path.join(REPO, "configs", "split-smoke.yaml")
    for load in (config.load_config, jconfig.load_config):
        with pytest.raises(ValueError, match="cycle"):
            load(path, cli_args=cli)


def test_bad_overrides_raise_as_in_jax():
    path = os.path.join(REPO, "configs", "split-smoke.yaml")
    for load in (config.load_config, jconfig.load_config):
        with pytest.raises(ValueError, match="key=value"):
            load(path, cli_args=["no_equals_sign"])
        with pytest.raises(KeyError):
            load(path, cli_args=["a=${nope:1}"])
        with pytest.raises(KeyError):
            load(path, cli_args=["a=${no.such.key}"])


def test_config_node_matches_jax():
    data = {"a": {"b": [1, {"c": "???"}]}, "d": 2}
    for mod in (config, jconfig):
        node = mod.ConfigNode(data)
        assert node.a.b[1]["c"] == "???"
        assert isinstance(node.a.b[1], mod.ConfigNode)
        node.set_dotted("x.y", 3)
        assert node.get_dotted("x.y") == 3 and node.get_dotted("a.b.0") == 1
        copied = node.copy()
        copied.a.b[0] = 5
        assert node.a.b[0] == 1
        with pytest.raises(AttributeError):
            node.missing
        with pytest.raises(ValueError):
            node.a.b[1].get("c")


def test_dump_config_reads_back(tmp_path):
    path = os.path.join(REPO, "configs", "split-mixed-occ-tensoir.yaml")
    cfg = config.load_config(path, cli_args=["dataset.scene=lego"])
    out = tmp_path / "config" / "parsed.yaml"
    config.dump_config(cfg, str(out))
    text = out.read_text()
    assert same(yaml.safe_load(text), cfg.to_primitive())
    assert same(yamlio.load(text), cfg.to_primitive())
    # what the JAX package's dump_config writes reads back the same
    jout = tmp_path / "jax" / "parsed.yaml"
    jconfig.dump_config(jconfig.load_config(path, cli_args=[
        "dataset.scene=lego"]), str(jout))
    assert same(yamlio.load_file(str(jout)), cfg.to_primitive())


@pytest.mark.parametrize("text,what", [
    ("a: !!str 1", "tags"), ("a: 1\n---\nb: 2\n", "several documents"),
    ("base: &b {x: 1}\nc:\n  <<: *b\n", "merge keys"),
    ("? [a]\n: 1", "complex keys"), ("a: |\n  x\n", "block scalars"),
    ("%YAML 1.1\n---\na: 1", "directives"), ("a: *nope", "names no anchor"),
    ("a:\n  b: 1\n c: 2", "line 3"), ("a: 'open", "not closed")])
def test_outside_the_subset_raises_naming_the_line(text, what):
    with pytest.raises(yamlio.YamlError, match=what) as err:
        yamlio.load(text, "cfg.yaml")
    assert "cfg.yaml, line" in str(err.value)


def test_scalars_resolve_as_yaml_1_1():
    text = ("a: 1e-3\nb: 1.0e-3\nc: .5\nd: 1_000\ne: 0x10\nf: 010\ng: yes\n"
            "h: on\ni: True\nj: ~\nk: null\nl:\nm: 'yes'\nn: 1:30\n"
            "o: -.inf\np: 0b11\nq: 2001-12-14\nr: 2001-12-14t21:59:43.10-05:00"
            "\ns: \"\\x41\\u00e9\\N\"\nt: Off\n")
    got, want = yamlio.load(text), yaml.safe_load(text)
    assert same(got, want)
    assert got["a"] == "1e-3" and got["b"] == 1e-3 and got["e"] == 16
    assert got["f"] == 8 and got["g"] is True and got["l"] is None


# PyYAML writes an empty or multi-line key as a complex key ``?``
KEYS = st.text(st.characters(blacklist_characters="\n\r\x85\u2028\u2029",
                             blacklist_categories=("Cs",)), min_size=1,
               max_size=12)
SCALARS = (st.none() | st.booleans() | st.integers()
           | st.floats(allow_nan=True, allow_infinity=True)
           | st.text(st.characters(blacklist_categories=("Cs",)),
                     max_size=60)
           | st.sampled_from([" \x85 nel", "a\u2028b", "yes", "No", "~", "1e-3", "010", "0x1F", ".5",
                              "1_0", "- a", "a: b", "#c", "'q'", '"d"',
                              "x #y", "&a", "*a", "!t", "%p", "@", "[1]",
                              "{a: 1}", "---", "...", " lead", "trail ",
                              "2001-01-01", "<<", "=", "", "long " * 30]))
DOCS = st.recursive(SCALARS, lambda inner: st.lists(inner, max_size=4)
                    | st.dictionaries(KEYS, inner, max_size=4),
                    max_leaves=25)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=DOCS, flow=st.sampled_from([False, None, True]),
       width=st.sampled_from([20, 40, 80]),
       indent=st.integers(2, 5), unicode=st.booleans(),
       start=st.booleans(), end=st.booleans())
def test_reader_equals_safe_load_on_what_safe_dump_writes(
        data, flow, width, indent, unicode, start, end):
    text = yaml.safe_dump(data, default_flow_style=flow, width=width,
                          indent=indent, allow_unicode=unicode,
                          explicit_start=start, explicit_end=end,
                          sort_keys=False)
    if "\u2028" in text or "\u2029" in text:  # raw: outside the subset
        with pytest.raises(yamlio.YamlError, match="separators"):
            yamlio.load(text)
        return
    assert same(yamlio.load(text), yaml.safe_load(text)), text


WRITABLE = st.recursive(
    SCALARS, lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(KEYS | st.integers() | st.booleans(), inner,
                      max_size=4), max_leaves=25)


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=WRITABLE)
def test_writer_round_trips(data):
    text = yamlio.dump(data)
    assert same(yaml.safe_load(text), data), text
    assert same(yamlio.load(text), data), text
