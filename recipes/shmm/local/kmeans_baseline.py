"""K-means frame-clustering baseline for AUD scoring.

The weakest credible AUD baseline (recipes are scored against a
k-means-on-frames floor): Lloyd's algorithm on the *training* features,
per-frame cluster assignment on the *eval* features, labels written in
the ali format ``score.py`` consumes.  No temporal model — any HMM-based
system should clear this.
"""

import argparse

import numpy as np


def kmeans(x, k, iters=50, seed=0):
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([
            x[assign == j].mean(0) if (assign == j).any() else centers[j]
            for j in range(k)
        ])
        if np.allclose(new, centers, atol=1e-6):
            break
        centers = new
    return centers


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("train_feats", help="training .npz archive")
    ap.add_argument("eval_feats", help="eval .npz archive")
    ap.add_argument("out_ali", help="hypothesis alignment output")
    ap.add_argument("--clusters", type=int, default=15)
    args = ap.parse_args()

    train = np.load(args.train_feats)
    x = np.concatenate([train[u] for u in train.files])
    centers = kmeans(x, args.clusters)

    ev = np.load(args.eval_feats)
    lines = []
    for utt in ev.files:
        f = ev[utt]
        d = ((f[:, None, :] - centers[None]) ** 2).sum(-1)
        labels = d.argmin(1)
        lines.append(f"{utt} {' '.join(f'u{v}' for v in labels)}")
    with open(args.out_ali, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {args.out_ali} ({len(lines)} utterances, "
          f"{args.clusters} clusters)")


if __name__ == "__main__":
    main()
