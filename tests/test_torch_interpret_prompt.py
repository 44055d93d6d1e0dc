"""Port vs reference: prompt interpretation, the nearest vocabulary words.

- planted context vectors (table rows plus 1e-2 noise) recover their rows,
  nearest first (``tests/test_probe_and_tools.py``'s check);
- on a seeded 2000 x 64 table with 8 context vectors, the top-5 indices
  are ``ppt_tpu.tasks.interpret_prompt.nearest_words``' and the squared
  distances within 1e-6 of ``|c|^2 + |t|^2`` of them (both sides use the
  expanded form in f32, whose rounding is of that size: a distance near 0
  is good to its square root, ~3e-3 here); a duplicated row planted as an
  exact tie goes to the lower index, as ``lax.top_k`` orders it;
- ``main`` from argv reads a ``checkpoint_best.pt`` prompt and the
  ``slip_text.msgpack`` table and prints the reference's lines.
"""

import numpy as np
import torch

from ppt_torch.tasks import interpret_prompt as tip
from ppt_torch.utils.msgpack import msgpack_serialize

torch.set_num_threads(1)  # one intra-op thread: the xdist workers share the cores

D2_TOL = 1e-6  # of the largest |c|^2 + |t|^2


class FakeTok:
    decoder = {i: f"tok{i}</w>" for i in range(2000)}


def test_recovers_planted_tokens():
    rng = np.random.RandomState(0)
    table = rng.randn(200, 8).astype(np.float32)
    ctx = table[[5, 17, 60]] + rng.randn(3, 8).astype(np.float32) * 0.01
    out = tip.nearest_words(ctx, table, topk=3, tokenizer=FakeTok())
    assert [row[0][0] for row in out] == ["tok5", "tok17", "tok60"]
    assert all(row[0][1] < row[1][1] <= row[2][1] for row in out)  # sorted by distance


def test_indices_and_distances_match_the_reference_with_an_exact_tie():
    from ppt_tpu.tasks.interpret_prompt import nearest_words

    rng = np.random.RandomState(1)
    table = rng.randn(2000, 64).astype(np.float32)
    table[1500] = table[300]  # an exact tie: 300 must come before 1500
    table[1700] = table[42]
    ctx = rng.randn(8, 64).astype(np.float32)
    ctx[0] = table[300] + 1e-3 * rng.randn(64).astype(np.float32)
    ctx[1] = table[42]  # distance 0 to both copies
    got = tip.nearest_words(ctx, table, topk=5, tokenizer=FakeTok())
    want = nearest_words(ctx, table, topk=5, tokenizer=FakeTok())
    assert [[w for w, _ in row] for row in got] == [[w for w, _ in row] for row in want]
    norms = (ctx * ctx).sum(-1).max() + (table * table).sum(-1).max()
    np.testing.assert_allclose(np.square([[d for _, d in row] for row in got]),
                               np.square([[d for _, d in row] for row in want]), rtol=0,
                               atol=D2_TOL * norms)
    # the port's distances to the two copies are the same number: the tie is exact
    for row, pair in ((0, ["tok300", "tok1500"]), (1, ["tok42", "tok1700"])):
        assert [w for w, _ in got[row][:2]] == pair and got[row][0][1] == got[row][1][1]
    idx, dist = tip.nearest_indices(torch.from_numpy(ctx), torch.from_numpy(table), 5)
    assert idx.shape == dist.shape == (8, 5) and float(dist[1, 0]) <= np.sqrt(D2_TOL * norms)


def test_main_reads_a_pt_prompt_and_a_msgpack_table(tmp_path, capsys):
    """The checkpoint as ``save_checkpoint`` writes one (its directory given)
    and the converted SLIP file: one line a context vector, the planted
    rows' words first."""
    from ppt_torch.tasks.args import parse_args
    from ppt_torch.train.checkpoint import FILE

    rng = np.random.RandomState(2)
    table = rng.randn(512, 16).astype(np.float32)
    planted = [7, 42, 99, 400]
    learnable = table[planted] + rng.randn(4, 16).astype(np.float32) * 1e-3
    run = tmp_path / "run"
    run.mkdir()
    torch.save({"trainable": {tip.PROMPT_KEY: torch.from_numpy(learnable)}, "opt_state": {},
                "batch_stats": {}, "step": 3}, run / FILE)
    pre = tmp_path / "pretrained"
    pre.mkdir()
    (pre / "slip_text.msgpack").write_bytes(msgpack_serialize(
        {"params": {"text": {"token_embedding": {"embedding": table}}}}))
    results = tip.main(["--fpath", str(run), "--pretrained_dir", str(pre), "--topk", "3",
                        "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(results) == 4 and all(len(row) == 3 for row in results)
    assert [ln.split(":")[0] for ln in out] == [f"ctx[{i:2d}]" for i in range(4)]
    assert out[0] == "ctx[ 0]: " + ", ".join(f"{w!r}({d:.3f})" for w, d in results[0])
    for i, row in enumerate(results):
        assert row[0][1] < 0.01  # the planted row
        want = tip.ClipTokenizer().decoder[planted[i]].replace("</w>", "")
        assert row[0][0] == want
    # the file itself, not only its directory
    assert tip.main(parse_args(["--fpath", str(run / FILE), "--pretrained_dir", str(pre),
                                "--topk", "3", "--device", "cpu"])) == results
