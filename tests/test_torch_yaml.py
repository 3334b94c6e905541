"""The port's YAML reader (``dynamo_tpu_torch/utils/yaml_lite.py``) against
``yaml.safe_load``: every recipe in ``recipes/``, the YAML documents the
JAX package's own tests write (read out of their source), the chaos plan
in ``chaos/plan.py``'s docstring, a table of scalars and flow forms, and
documents ``yaml.safe_dump`` writes for drawn values (block and flow
styles). What the reader does not read is refused by name.
"""

from __future__ import annotations

import ast
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.utils import yaml_lite
from dynamo_tpu_torch.utils.yaml_lite import YamlError

ROOT = Path(__file__).resolve().parent.parent
RECIPES = sorted((ROOT / "recipes").rglob("*.yaml"))


def same(a, b) -> bool:
    """Equal, with NaN equal to NaN and types compared (1 is not 1.0 or True)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def check(text: str) -> None:
    """The reader gives what ``yaml.safe_load`` gives, or fails where it fails."""
    try:
        ref = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(YamlError):
            yaml_lite.safe_load(text)
        return
    got = yaml_lite.safe_load(text)
    assert same(got, ref), (text, got, ref)


def written_yaml(test_file: str, func: str) -> str:
    """The string constant a test function passes to ``write_text``."""
    tree = ast.parse((ROOT / "tests" / test_file).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write_text" and node.args
                and isinstance(node.args[0], ast.Constant)):
            return node.args[0].value
    raise AssertionError(f"{test_file}::{func} writes no YAML")


def test_recipes_exist():
    assert len(RECIPES) >= 5


@pytest.mark.parametrize("path", RECIPES, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_every_recipe_reads_as_safe_load_reads_it(path):
    check(path.read_text())


@pytest.mark.parametrize("test_file,func", [
    ("test_chaos.py", "test_plan_load_yaml_file_and_inline_json"),
    ("test_parsers.py", "test_recipe_null_parsers_key"),
])
def test_the_jax_tests_documents(test_file, func):
    text = written_yaml(test_file, func)
    check(text)
    if func == "test_recipe_null_parsers_key":
        assert yaml_lite.safe_load(text)["spec"]["parsers"] is None


def test_the_chaos_plan_docstring():
    from dynamo_tpu_torch.chaos import plan

    doc = plan.__doc__
    text = doc.split("```yaml\n", 1)[1].split("```", 1)[0]
    check(text)
    loaded = plan.ChaosPlan.from_dict(yaml_lite.safe_load(text))
    assert loaded.rules[0].match == {"endpoint": "generate"} and loaded.rules[0].count == 3


SCALARS = ["1", "-7", "+12", "0", "-0", "017", "-017", "08", "0x1F", "0b101", "1_000",
           "1:30", "1:30.5", "1.5", "1.", ".5", "-1.5e-3", "1.0e+5", "1e5", "1.0e5",
           ".inf", "-.Inf", ".NaN", "true", "False", "yes", "No", "on", "OFF", "y",
           "n", "~", "null", "Null", "NULL", "", "plain text", "a#b",
           "tcp://127.0.0.1:4222", "x-y_z.w", "'it''s'", '"a\\tb"', '"\\u00e9\\x41"',
           '"a # b"', "'a # b'", "value   # a comment", "-", "--x",
           # Unicode spaces are content, not YAML's white space
           "\xa0", "a\xa0", "\u2003b"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_yaml_1_1(scalar):
    check(f"k: {scalar}\n")
    check(f"- {scalar}\n")


FLOWS = ["{a: 1, b}", "[1, 2,]", "[a, b: c]", '{"a":1, "b": [true, no]}', "{a: 1}",
         "[ ]", "{x: }", "[[1, 2], {a: {b: [c]}}]", "{a:1}", '[a, "b, c", \'d\']',
         "[1,\n  2]", "{\n  a: 1,  # c\n  b: [x,\n     y]\n}"]


@pytest.mark.parametrize("flow", FLOWS)
def test_flow_collections(flow):
    check(f"k: {flow}\n")
    check(flow)


BLOCKS = ["a:\n- 1\n- 2\nb: 3", "- - a\n  - b\n- c", "- a: 1\n  b: 2\n-\n  c: 3\n- ",
          "a:\n  b:\n    c: 1\n  d: 2", "---\na: 1", "# only a comment\n", "",
          '"k k": 1\n\'q\': 2', "1: a\n2.5: b\ntrue: c\n~: d", "a: 1\n\n\n# c\nb: 2\n",
          "- [1, 2]\n- {a: b}", "a:\r\n  b: 1\r\n"]


@pytest.mark.parametrize("block", BLOCKS)
def test_block_collections(block):
    check(block)


REFUSED = [
    ("a: &x 1\nb: *x\n", "anchors are not read"),
    ("a: *x\n", "aliases are not read"),
    ("a: !!str 1\n", "tags are not read"),
    ("a: |\n  x\n", "block scalars"),
    ("a: >\n  x\n", "block scalars"),
    ("a: 1\n---\nb: 2\n", "several documents"),
    ("a: 1\n...\n", "several documents"),
    ("%YAML 1.1\n---\na: 1\n", "directives are not read"),
    ("? a\n: b\n", "complex keys"),
    ("a: 2001-12-14\n", "timestamps are not read"),
    ('a: "x\n  y"\n', "quoted scalars over several lines"),
    ("a: x\n  y\n", "scalars over several lines"),
    ("a:\n\t- 1\n", "tabs in indentation"),
    ("<<: {a: 1}\n", "merge keys"),
    ("{a: [1, 2\n", "unclosed flow"),
]


@pytest.mark.parametrize("text,needle", REFUSED, ids=[n for _, n in REFUSED])
def test_refused_by_name(text, needle):
    with pytest.raises(YamlError, match=needle):
        yaml_lite.safe_load(text)


_keys = st.text(st.characters(min_codepoint=ord("a"), max_codepoint=ord("z")), min_size=1,
                max_size=8)
_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-10**12, 10**12),
    st.floats(allow_nan=False, width=64),
    st.text(st.characters(blacklist_categories=("Cs", "Cc", "Zl", "Zp")), max_size=12))
_values = st.recursive(_scalars, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_keys, inner, max_size=4)), max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(doc=st.dictionaries(_keys, _values, max_size=5), flow=st.booleans())
def test_safe_dump_documents_read_back(doc, flow):
    text = yaml.safe_dump(doc, default_flow_style=flow, width=10**6, allow_unicode=True)
    try:
        got = yaml_lite.safe_load(text)
    except YamlError as exc:
        # only what the reader refuses by name: a string safe_dump wrote
        # as a quoted scalar over several lines
        assert "over several lines" in str(exc), (text, exc)
        return
    assert same(got, yaml.safe_load(text)), text
