"""Dataset pipeline: MNIST / FashionMNIST / CIFAR-10 / CIFAR-3.

Rebuild of dataset_loaders.py:18-136 without torchvision:
  * readers for the standard on-disk formats (MNIST idx / idx.gz,
    CIFAR-10 python pickle batches or binary batches) under ``data_root``;
  * a deterministic synthetic fallback (clearly flagged) so training,
    tests and benchmarks run in this zero-egress environment;
  * the reference's split conventions: MNIST/FashionMNIST random 90/10
    train/val split; CIFAR val == test set (:66-94);
  * augmentation — random crop with 4-pixel padding + horizontal flip —
    applied on-device in the jitted train step (see ``augment_batch``), not
    in host worker processes: the on-device replacement for the reference's
    torchvision transform + DataLoader-worker pipeline;
  * no normalisation here — it lives inside the model (models/layers.py
    Normalize) so attacks/certification act in [0,1] pixel space.

Images are NCHW float32 in [0,1]; the whole dataset is held in host RAM
(60k x 3 x 32 x 32 floats = 0.7 GB) and minibatches are device_put with the
data-parallel sharding by the trainer.
"""
from __future__ import annotations

import dataclasses
import gzip
import pickle
import struct
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Dataset", "load_dataset", "augment_batch", "check_data_root",
           "DATASET_INFO"]

DATASET_INFO = {
    # name: (channels, size, n_classes, mu, std)
    "MNIST": (1, 28, 10, (0.1307,), (0.3081,)),
    "FashionMNIST": (1, 28, 10, (0.5,), (0.5,)),
    "CIFAR10": (3, 32, 10, (0.485, 0.456, 0.406), (0.225, 0.225, 0.225)),
    "CIFAR3": (3, 32, 3, (0.485, 0.456, 0.406), (0.225, 0.225, 0.225)),
}


@dataclasses.dataclass
class Dataset:
    name: str
    train_x: np.ndarray  # (N, C, H, W) float32 in [0,1]
    train_y: np.ndarray  # (N,) int32
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int
    synthetic: bool = False

    @property
    def image_shape(self):
        return self.train_x.shape[1:]


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        magic = struct.unpack(">I", fh.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        data = np.frombuffer(fh.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: Path, names) -> Optional[Path]:
    for n in names:
        for cand in (root / n, root / (n + ".gz")):
            if cand.exists():
                return cand
    return None


def _load_mnist_like(root: Path, prefix: str):
    files = {
        "train_x": [f"{prefix}train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "train_y": [f"{prefix}train-labels-idx1-ubyte", "train-labels.idx1-ubyte"],
        "test_x": [f"{prefix}t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
        "test_y": [f"{prefix}t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"],
    }
    out = {}
    for k, names in files.items():
        p = _find(root, names)
        if p is None:
            return None
        out[k] = _read_idx(p)
    tx = out["train_x"].astype(np.float32)[:, None] / 255.0
    ty = out["train_y"].astype(np.int32)
    sx = out["test_x"].astype(np.float32)[:, None] / 255.0
    sy = out["test_y"].astype(np.int32)
    return tx, ty, sx, sy


def _load_cifar10(root: Path):
    pydir = root / "cifar-10-batches-py"
    if pydir.exists():
        xs, ys = [], []
        for i in range(1, 6):
            with open(pydir / f"data_batch_{i}", "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        with open(pydir / "test_batch", "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        tx = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        ty = np.concatenate(ys).astype(np.int32)
        sx = d[b"data"].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        sy = np.asarray(d[b"labels"], np.int32)
        return tx, ty, sx, sy
    bindir = root / "cifar-10-batches-bin"
    if bindir.exists():
        def read_bin(p):
            raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
            return (
                raw[:, 1:].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0,
                raw[:, 0].astype(np.int32),
            )

        xs, ys = zip(*(read_bin(bindir / f"data_batch_{i}.bin") for i in range(1, 6)))
        sx, sy = read_bin(bindir / "test_batch.bin")
        return np.concatenate(xs), np.concatenate(ys), sx, sy
    return None


def _synthetic(name: str, n_train=4096, n_test=512, seed=0, hardness=0.0):
    """Deterministic class-structured fake data (per-class gaussian blobs).

    ``hardness`` in [0, 1] makes the task genuinely non-separable by
    calibrating the typical class-pair prototype distance in units of the
    per-pixel noise sigma: 6sigma at hardness->0+ (near-zero Bayes error)
    down to 1.5sigma at hardness=1.  In 3072 raw dimensions only the
    separation along the class discriminant matters, so an uncalibrated
    "pull toward the mean" leaves the task linearly separable at any
    blend factor — measured: a ridge probe still scores 100% at the old
    hardness=0.9.  The sigma-calibrated scale puts test points within the
    certification budget eps=36/255 of the Bayes boundary, so clean
    accuracy < 100% and AutoAttack faces real adversarials.  0.0 keeps
    the original well-separated set (all committed round-1/2 artifacts),
    bit-identical for the same seed.
    """
    c, hw, ncls, _, _ = DATASET_INFO[name]
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.2, 0.8, size=(ncls, c, hw, hw)).astype(np.float32)
    noise = 0.1 + 0.25 * float(hardness)
    if hardness > 0.0:
        mean_p = protos.mean(0, keepdims=True)
        resid = protos - mean_p
        flat = resid.reshape(ncls, -1)
        pd = np.sqrt(((flat[:, None] - flat[None]) ** 2).sum(-1))
        d_mean = pd[~np.eye(ncls, dtype=bool)].mean()
        sep_sigmas = 6.0 * (1.0 - float(hardness)) + 1.5 * float(hardness)
        protos = (mean_p + (noise * sep_sigmas / d_mean) * resid).astype(
            np.float32
        )

    def make(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, ncls, size=n).astype(np.int32)
        x = protos[y] + noise * r.standard_normal((n, c, hw, hw)).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    tx, ty = make(n_train, seed + 1)
    sx, sy = make(n_test, seed + 2)
    return tx, ty, sx, sy


def load_dataset(
    name: str,
    data_root: str = "data",
    val_fraction: float = 0.1,
    seed: int = 0,
    allow_synthetic: bool = True,
    synthetic_size: int = 4096,
    synthetic_hardness: float = 0.0,
) -> Dataset:
    root = Path(data_root)
    raw = None
    synthetic = False
    if name in ("MNIST", "FashionMNIST"):
        sub = root / name
        for r in (sub, sub / "raw", root):
            raw = _load_mnist_like(r, "")
            if raw is not None:
                break
    elif name in ("CIFAR10", "CIFAR3"):
        raw = _load_cifar10(root)
    else:
        raise ValueError(f"unknown dataset {name!r}")

    if raw is None:
        if not allow_synthetic:
            raise FileNotFoundError(f"no {name} files under {root}")
        raw = _synthetic(name, n_train=synthetic_size,
                         n_test=max(synthetic_size // 8, 64),
                         hardness=synthetic_hardness)
        synthetic = True
    tx, ty, sx, sy = raw

    n_classes = DATASET_INFO[name][2]
    if name == "CIFAR3":
        keep = ty < 3
        tx, ty = tx[keep], ty[keep]
        keep = sy < 3
        sx, sy = sx[keep], sy[keep]

    if name in ("MNIST", "FashionMNIST"):
        # random 90/10 split (dataset_loaders.py:36-40)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(tx))
        n_val = int(val_fraction * len(tx))
        val_idx, train_idx = idx[:n_val], idx[n_val:]
        vx, vy = tx[val_idx], ty[val_idx]
        tx, ty = tx[train_idx], ty[train_idx]
    else:
        # CIFAR: validation == test set (dataset_loaders.py:92-94)
        vx, vy = sx, sy

    return Dataset(name, tx, ty, vx, vy, sx, sy, n_classes, synthetic)


def check_data_root(name: str, data_root: str = "data") -> dict:
    """Dry-check dropped-in real dataset files (no device work).

    The ±0.5% accuracy-parity claim (BASELINE.md "Blocked") needs real
    MNIST idx / CIFAR batch files this zero-egress box does not ship.
    This verifies a drop-in by structure — file discovery through the
    same ``load_dataset`` probing order, then shape / dtype / label-range
    / per-class-count / pixel-statistics invariants plus a sha256 of the
    raw arrays — so the day files appear, ``fiode_tpu data-check`` says
    in seconds whether the parity run is ready (reference loaders:
    dataset_loaders.py:18-136 trust torchvision's own checksums instead).

    Returns a JSON-able report; ``report["ok"]`` is the verdict.
    """
    import hashlib

    report = {"dataset": name, "data_root": data_root, "ok": False,
              "checks": [], "errors": []}

    def check(label, cond, detail=""):
        report["checks"].append(
            {"check": label, "ok": bool(cond), "detail": detail})
        if not cond:
            report["errors"].append(f"{label}: {detail}")
        return bool(cond)

    try:
        ds = load_dataset(name, data_root=data_root, allow_synthetic=False)
    except (FileNotFoundError, ValueError) as e:
        report["errors"].append(str(e))
        layout = ("data/<name>[/raw]/{train,t10k}-{images,labels}-idx*-ubyte"
                  "[.gz]" if name in ("MNIST", "FashionMNIST") else
                  "data/cifar-10-batches-py/{data_batch_1..5,test_batch} or "
                  "data/cifar-10-batches-bin/*.bin")
        report["expected_layout"] = layout
        return report

    C, S, n_classes, mu, _ = DATASET_INFO[name]
    n_train_expect = {"MNIST": 60000, "FashionMNIST": 60000,
                      "CIFAR10": 50000, "CIFAR3": 15000}[name]
    n_test_expect = {"MNIST": 10000, "FashionMNIST": 10000,
                     "CIFAR10": 10000, "CIFAR3": 3000}[name]
    n_total_train = len(ds.train_x) + (
        len(ds.val_x) if name in ("MNIST", "FashionMNIST") else 0)
    check("not synthetic", not ds.synthetic)
    check("train size", n_total_train == n_train_expect,
          f"{n_total_train} vs {n_train_expect}")
    check("test size", len(ds.test_x) == n_test_expect,
          f"{len(ds.test_x)} vs {n_test_expect}")
    check("image shape", ds.test_x.shape[1:] == (C, S, S),
          f"{ds.test_x.shape[1:]} vs {(C, S, S)}")
    check("pixel range", float(ds.test_x.min()) >= 0.0
          and float(ds.test_x.max()) <= 1.0,
          f"[{float(ds.test_x.min()):.3f}, {float(ds.test_x.max()):.3f}]")
    labels = np.concatenate([ds.train_y, ds.test_y])
    check("label range", labels.min() >= 0 and labels.max() < ds.n_classes,
          f"[{labels.min()}, {labels.max()}] vs [0, {ds.n_classes})")
    counts = np.bincount(ds.test_y, minlength=ds.n_classes)
    # real test sets are class-balanced to within a few % (exactly 1000
    # per class for CIFAR-10; MNIST varies 892..1135)
    check("test class balance",
          counts.min() > 0.8 * counts.mean(),
          f"per-class test counts {counts.tolist()}")
    px_mean = float(ds.test_x.mean())
    mu_bar = float(np.mean(mu))
    check("pixel mean sanity", abs(px_mean - mu_bar) < 0.2,
          f"test-set mean {px_mean:.4f} vs canonical ~{mu_bar:.4f}")
    report["sha256_test_x"] = hashlib.sha256(
        np.ascontiguousarray(ds.test_x)).hexdigest()
    report["sha256_test_y"] = hashlib.sha256(
        np.ascontiguousarray(ds.test_y)).hexdigest()
    report["ok"] = not report["errors"]
    return report


def augment_batch(key, x):
    """Random crop (pad 4, reflect of zeros as in torchvision default) +
    horizontal flip, fully on-device (vectorised gather, no host loop)."""
    B, C, H, W = x.shape
    kc, kf = jax.random.split(key)
    pad = 4
    xp = jnp.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    off = jax.random.randint(kc, (B, 2), 0, 2 * pad + 1)
    rows = off[:, 0:1, None] + jnp.arange(H)[None, :, None]  # (B,H,1)
    cols = off[:, 1:2, None] + jnp.arange(W)[None, None, :]  # (B,1,W)
    batch_idx = jnp.arange(B)[:, None, None]
    cropped = xp[batch_idx, :, rows, cols]  # (B,H,W,C)
    cropped = jnp.moveaxis(cropped, -1, 1)
    flip = jax.random.bernoulli(kf, 0.5, (B,))
    flipped = jnp.where(flip[:, None, None, None], cropped[..., ::-1], cropped)
    return flipped
