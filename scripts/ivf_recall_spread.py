"""Spread of the ivf1m recall ratios between builds, on a CUDA card.

Builds the ivf1m index of ``chip_smoke.py`` (1,000,000 x 96, PQ 12x256,
1000 partitions, probe 50) several times; the coarse k-means is not
bit-reproducible on the card, so each build differs a little. For each
build it prints one JSON line: recall@10 of the masked scan and of the
``pallas`` routes (4 winners; 2 winners with and without rescore 4) over
1,000 and over 10,000 sampled self-queries, the same routes' ratio to
the masked scan, the 2-winner + rescore route once more with K1's plain
PyTorch version in place of the kernel, and how many of K1's 2-winner
outputs on the padded operands equal the plain version's, bit for bit
and by row.

    python3 scripts/ivf_recall_spread.py --builds 3
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--builds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ivf_recall_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import gulon_tpu_torch as gt
    from gulon_tpu_torch.ops.cuda import adc

    n, d = 1_000_000, 96
    x = chip_smoke.low_rank_corpus(args.seed, n, d, intrinsic=24, n_clusters=4096)
    keys = np.array([f"r{i:08d}" for i in range(n)], dtype=object)
    truths = {
        s: gt.sample_ground_truth(keys, x, num_samples=s, ks=(10,), device="cuda")
        for s in (1000, 10_000)
    }
    kernel = adc.fused_block_scan
    q = torch.from_numpy(
        x[np.random.default_rng(args.seed + 5).choice(n, 1024, replace=False)]
    ).cuda()
    for b in range(args.builds):
        t0 = time.perf_counter()
        index = gt.build_ivf_index(
            keys, x,
            pq_config=gt.PQConfig(
                num_clusters=256, num_quantizers=12, max_iters=10,
                train_sample=200_000,
            ),
            coarse_max_iters=10, device="cuda",
        )
        routes = {
            "masked": dataclasses.replace(index, scan_strategy="masked"),
            "w4": index,
            "w2_rescore4": dataclasses.replace(index, pallas_winners=2, pallas_rescore=4),
            "w2": dataclasses.replace(index, pallas_winners=2),
        }
        rc_pal = index._pallas_operands()[0]
        codes_t = index._pallas_codes()
        out = dict(build=b, padded_rows=int(codes_t.shape[1]))
        for s, truth in truths.items():
            rec = {name: gt.recall_of(idx, truth, x, keys)[10].mean for name, idx in routes.items()}
            adc.fused_block_scan = adc._block_scan_plain
            try:
                rec["w2_rescore4_plain"] = gt.recall_of(
                    routes["w2_rescore4"], truth, x, keys
                )[10].mean
            finally:
                adc.fused_block_scan = kernel
            out[f"recall10_{s}"] = rec
            out[f"ratio_{s}"] = {k: v / rec["masked"] for k, v in rec.items() if k != "masked"}

        pq = index.pq
        ops = adc.prepare_scan_operands(
            q, pq.codebooks, codes_t, rc_pal, bounds=pq.bounds, tile_rows=0,
            num_rows=codes_t.shape[1], winners=2, center_scores=False,
        )
        operands = (
            ops["codes_t"], adc._split_hi_lo(ops["norms"], ops["center"]),
            ops["q_pad"][: len(q)].to(torch.bfloat16),
            pq.codebooks.to(torch.bfloat16).contiguous(),
        )
        nblk = ops["t"] // 128
        got = kernel(*operands, winners=2, nblk=nblk).view(torch.int32)
        ref = adc._block_scan_plain(*operands, winners=2, nblk=nblk).view(torch.int32)
        out["w2_bits_equal"] = float((got == ref).float().mean())
        out["w2_rows_equal"] = float(((got & 127) == (ref & 127)).float().mean())
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
