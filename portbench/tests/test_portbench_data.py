"""The generators: the same seed gives the same inputs, every seed the same sizes."""
import torch

from portbench import discover, seeds

CPU = torch.device("cpu")


def _spec(config):
    cfg = discover.json_part("configs", config)
    cfg["data"].update(cfg["rehearsal"])
    return cfg["data"]


def test_part_seeds_take_large_seeds_and_differ():
    big = 2**31 + 12_345
    assert seeds.part_seed(big, 0) == seeds.part_seed(big, 0) < 2**63
    assert len({seeds.part_seed(s, p) for s in (0, 1, big, 2**40) for p in range(4)}) == 16


def test_image_pairs_same_seed_same_images():
    gen, spec = discover.module("data", "image_pairs"), _spec("div2k_image_quality")
    a, b, c = (gen.make(spec, s, 0, 1, CPU) for s in (7, 7, 2**32 + 7))
    assert torch.equal(a["arrays"]["preds"], b["arrays"]["preds"])
    assert not torch.equal(a["arrays"]["preds"], c["arrays"]["preds"])
    assert [tuple(x["preds"].shape) for x in a["batches"]] == [tuple(x["preds"].shape) for x in c["batches"]]
    p, t = a["arrays"]["preds"], a["arrays"]["target"]
    assert p.shape == (spec["crops"], 3, spec["height"], spec["width"]) and 0 <= float(p.min()) <= float(p.max()) <= 1
    assert 0.1 < float(t.min()) and float(t.max()) < 0.9


def test_scored_rows_split_over_ranks_is_the_one_card_set():
    gen, spec = discover.module("data", "scored_rows"), _spec("criteo_exact_auc")
    whole = gen.make(spec, 11, 0, 1, CPU)
    quarters = [gen.make(spec, 11, r, 4, CPU) for r in range(4)]
    for k in ("preds", "target"):
        assert torch.equal(whole["arrays"][k], torch.cat([q["arrays"][k] for q in quarters]))
    assert sum(gen.part_rows(spec)) == spec["rows"] == len(whole["arrays"]["preds"])
    sizes = [len(u["preds"]) for u in whole["updates"]]
    assert sum(sizes) == spec["rows"] and set(sizes[:-1]) == {spec["update_rows"]}
    for q in quarters:  # each rank's update is its quarter of an eval batch, and every rank updates as often
        shares = [len(u["preds"]) for u in q["updates"]]
        assert set(shares[:-1]) == {spec["update_rows"] // 4} and len(shares) == len(quarters[0]["updates"])
    assert whole["arrays"]["target"].dtype == torch.int64 and whole["arrays"]["preds"].dtype == torch.float32
    other = gen.make(spec, 12, 0, 1, CPU)
    assert not torch.equal(whole["arrays"]["preds"], other["arrays"]["preds"])


def test_scored_rows_at_the_cell_size_split_as_the_config_says():
    cfg = discover.json_part("configs", "criteo_exact_auc")["data"]
    gen = discover.module("data", "scored_rows")
    assert gen.part_rows(cfg) == [22_284_330, 22_284_330, 22_284_330, 22_284_329]
    n = cfg["rows"]
    assert divmod(n, cfg["update_rows"]) == (5_440, 8_359)
    assert divmod(22_284_330, cfg["update_rows"] // 4) == (5_440, 2_090)
