"""The control at a size a test run holds: the reference computed with fp8
products in the program's place has to come out not correct, through the
same judgement as a run's (`check.judge`, `check.passed`), where the bf16
program comes out correct, at a bf16 configuration of the cells' shape
(GQA and MHA, head dim 128) cut to 2 layers and a small vocabulary.

LIMIT is set at this size as the cells' limits are: the program read at
most 0.0086 over seeds 21-26 (both head layouts), the control at least
0.0999.  The readings at the cells' own sizes come from
`benchmark/readings.py` on the card."""

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import readings

from .conftest import TINY, make_root

SMALL = {**TINY, "hidden_size": 512, "num_attention_heads": 4, "intermediate_size": 1024,
         "num_hidden_layers": 2, "vocab_size": 2048, "torch_dtype": "bfloat16"}
LIMIT = 0.03


@pytest.mark.parametrize("kv", [1, 4])
def test_control_comes_out_not_correct(tmp_path, kv):
    root = make_root(tmp_path, {**SMALL, "num_key_value_heads": kv}, limit=LIMIT)
    out = io.StringIO()
    with redirect_stdout(out):
        readings.main(["--workload", "mistral7b.solo", "--seeds", "21,22,23",
                       "--control", "21,22,23", "--seconds", "1"], root=root, device="cpu")
    rows = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert len(rows) == 3
    assert all(r["correct"] is True for r in rows), rows
    assert all(r["control_correct"] is False for r in rows), rows
