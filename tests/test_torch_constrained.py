"""PyTorch port: its own copy of the constrained-decoding tables
(``matryoshka_mm_torch/serve/constrained.py``, numpy only) gives the same
DFA, the same token tables, the same tokenizer vocabulary and the same JSON
schema regexes as ``matryoshka_mm_tpu/serve/constrained.py``.  Everything is
exact (integer tables and strings)."""

import re

import numpy as np
import pytest

from matryoshka_mm_tpu.serve import constrained as jc
from matryoshka_mm_torch.serve import constrained as tc

PATTERNS = ["abc", "a|bc", "ab*c", "ab+c", "ab?c", "[a-c]+", "[^a-c]+",
            r"\d{2,4}", r"(yes|no)( really)?", r"-?\d+(\.\d+)?",
            r"\w+@\w+\.(com|org)", r'"[^"]*"', r"A|B|C|D", r"x(yz|zy)+x",
            r"\s*\{\s*\}"]

VOCAB = ["<pad>", "</s>", "A", "B", "C", "D", "yes", "no", " really", "1",
         "2", ".", "12", " ", "maybe", "a", "b", "c", "ab", "bc", "@", "com",
         "org", '"', "x", "yz", "zy", "{", "}", "-", "3.1"]
EOS = 1


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_and_token_tables_equal_the_original(pattern):
    jd, td = jc.compile_regex(pattern), tc.compile_regex(pattern)
    assert (jd.step, jd.accept, jd.start) == (td.step, td.accept, td.start)
    assert td.n_states == jd.n_states
    for special in ((), (0,)):
        ja, jt = jc.build_token_tables(jd, VOCAB, EOS, special_ids=special)
        ta, tt = tc.build_token_tables(td, VOCAB, EOS, special_ids=special)
        assert ta.dtype == ja.dtype and tt.dtype == jt.dtype
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("pattern,alphabet", [
    (r"(ab|ba)*", "ab"), (r"a[bc]{1,3}d?", "abcd"),
    (r"\d+(\.\d{1,2})?", "0123."), (r"x(yz|zy)+x", "xyz")])
def test_dfa_fullmatch_agrees_with_re(pattern, alphabet):
    rng = np.random.default_rng(0)
    dfa = tc.compile_regex(pattern)
    for _ in range(200):
        n = int(rng.integers(0, 8))
        s = "".join(rng.choice(list(alphabet), n)) if n else ""
        assert dfa.fullmatch(s) == bool(re.fullmatch(pattern, s)), s


def test_token_tables_walk_a_match():
    dfa = tc.compile_regex(r"(yes|no)( really)?")
    allow, trans = tc.build_token_tables(dfa, VOCAB, EOS, special_ids=[0])
    s = dfa.start
    assert allow[s, VOCAB.index("yes")] and not allow[s, VOCAB.index("maybe")]
    assert not allow[s, EOS]
    s2 = trans[s, VOCAB.index("yes")]
    assert allow[s2, EOS] and allow[s2, VOCAB.index(" really")]
    s3 = trans[s2, VOCAB.index(" really")]
    assert allow[s3].nonzero()[0].tolist() == [EOS]


SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}},
     "required": ["name", "age"]},
    {"type": "array", "items": {"type": "number"}},
    {"enum": ["red", "green", 3]},
    {"type": "object", "properties": {"ok": {"type": "boolean"},
                                      "tags": {"type": "array", "items": {
                                          "type": "string"}}}},
]


@pytest.mark.parametrize("schema", SCHEMAS)
def test_json_schema_regex_equals_the_original(schema):
    assert tc.regex_for_json_schema(schema) == jc.regex_for_json_schema(
        schema)
    assert tc.regex_for_json_schema(schema, max_items=3) == \
        jc.regex_for_json_schema(schema, max_items=3)


def test_re_escape_and_vocab_from_tokenizer_equal_the_original():
    for s in ("a.b", "x|y(z)", "[q]*+?{}\\", "plain"):
        assert tc.re_escape(s) == jc.re_escape(s)

    class Tok:
        all_special_ids = [0, 1]

        vocab_size = 6

        def convert_ids_to_tokens(self, ids):
            pieces = ["<pad>", "</s>", "▁hello", "wor", "<0x0A>", "ld"]
            return [pieces[i] for i in ids]

    assert tc.vocab_from_tokenizer(Tok()) == jc.vocab_from_tokenizer(Tok())
