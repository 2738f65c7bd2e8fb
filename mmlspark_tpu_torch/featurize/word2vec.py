"""Word2Vec: skip-gram embeddings trained on the card.

Reference parity: the "TextAnalytics - Amazon Book Reviews with Word2Vec"
notebook leans on Spark ML's Word2Vec (an L0 dependency of the reference's
text journeys). ``transform`` averages word vectors per document (Spark
Word2Vec.transform semantics); ``find_synonyms`` does cosine top-k like the
Spark API.

The port's copy of ``mmlspark_tpu/featurize/word2vec.py``. The vocabulary,
the skip-gram pair table (built with numpy in the reference's order), the
``default_rng(seed)`` permutations and negatives stay host numpy, so the
draws are the reference's. The initial matrix is the reference's
``jax.random.normal(split(key(seed))[0], (V, D)) * 0.1`` through
``core/threefry.normal``, bit for bit on the card and the CPU. The jitted
SGD step becomes a torch step on ``resolve_device()`` under deterministic
algorithms (``models.training._deterministic``, so its bits repeat from call to
call on the card): it gathers the batch's rows, takes the mean
log-sigmoid loss, gets the rows' gradients by autograd, scatter-adds them
into each matrix's shape and updates it. A pass's pair order and
negatives go to the device once; on the card the step is one CUDA graph,
captured once and replayed (``_CapturedStep``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model
from ..core.schema import ColType, Schema
from ..core import graphs, threefry
from ..models.training import _deterministic
from ..runtime import resolve_device


def _tokens_of(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, str):
        return v.lower().split()
    return [str(t).lower() for t in v]


def _pair_table(docs: List[List[int]], win: int):
    """(centers, contexts) int32 of every skip-gram pair: per document, per
    position ``i``, its neighbours ``j`` within ``win`` (``j != i``) in
    increasing order, the reference's loop order."""
    lens = np.asarray([len(d) for d in docs], dtype=np.int64)
    ids = np.asarray([t for d in docs for t in d], dtype=np.int32)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.arange(len(ids), dtype=np.int64) - starts
    ends = np.repeat(lens, lens)
    offs = np.asarray([o for o in range(-win, win + 1) if o != 0],
                      dtype=np.int64)
    j = pos[:, None] + offs[None, :]
    ok = (j >= 0) & (j < ends[:, None])
    center = np.broadcast_to(np.arange(len(ids))[:, None], j.shape)[ok]
    context = (starts[:, None] + j)[ok]
    return ids[center], ids[context]


def sgd_step(w_in: torch.Tensor, w_out: torch.Tensor, cen: torch.Tensor,
             pos: torch.Tensor, neg: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGD step on a [B] batch of pairs (int64 ``cen``, ``pos``) with
    [B, K] negatives, in place on ``w_in`` and ``w_out``; returns the
    batch's loss (a device scalar): the reference's ``-mean(log_sigmoid(e
    . p) + sum_k log_sigmoid(-e . n_k))`` and its gradients, the rows'
    from autograd scatter-added into each matrix's shape (``index_add_``,
    in the order of the batch), then ``w - lr * grad``."""
    e = w_in[cen]
    p = w_out[pos]
    n = w_out[neg]
    with torch.enable_grad():
        e, p, n = (t.requires_grad_() for t in (e, p, n))
        pos_logit = (e * p).sum(-1)
        neg_logit = torch.einsum("bd,bkd->bk", e, n)
        loss = -torch.mean(torch.nn.functional.logsigmoid(pos_logit)
                           + torch.nn.functional.logsigmoid(-neg_logit).sum(-1))
        ge, gp, gn = torch.autograd.grad(loss, (e, p, n))
    with torch.no_grad():
        # the transposes of the three gathers; w_out's two (the positives',
        # the negatives') are summed after each is scattered, as jax.grad
        # adds the cotangents of its two uses of w_out
        g_in = torch.zeros_like(w_in).index_add_(0, cen, ge)
        g_out = torch.zeros_like(w_out).index_add_(0, pos, gp)
        g_out += torch.zeros_like(w_out).index_add_(
            0, neg.reshape(-1), gn.reshape(-1, gn.shape[-1]))
        w_in -= lr * g_in
        w_out -= lr * g_out
    return loss.detach()


def negative_cdf(neg_p: np.ndarray, device) -> torch.Tensor:
    """The f64 CDF ``Generator.choice`` builds from ``p`` (its cumulative
    sum over its last value), on ``device``."""
    cdf = neg_p.cumsum()
    cdf /= cdf[-1]
    return torch.from_numpy(cdf).to(device)


def draw_negatives(rng: np.random.Generator, cdf: torch.Tensor,
                   shape) -> torch.Tensor:
    """``rng.choice(V, size=shape[1:], p=p)`` for ``shape[0]`` steps at
    once: the same uniforms in the same order (``rng.random``), each placed
    in the CDF by ``searchsorted(side="right")`` on the CDF's device (the
    same f64 comparisons as numpy's), so the draws are the reference's."""
    u = torch.from_numpy(rng.random(shape)).to(cdf.device)
    return torch.searchsorted(cdf, u.reshape(-1), right=True).reshape(shape)


class _CapturedStep:
    """``sgd_step`` captured once in a CUDA graph (``core.graphs.Captured``)
    and replayed a step: each batch's indices are copied into the graph's
    inputs. The same kernels on the same inputs as the eager step, so the
    same bits, without a launch's host cost per kernel. The first call runs
    on copies of the matrices (it builds the handles and makes the
    allocations the capture may not), so they move only on the replays."""

    def __init__(self, w_in, w_out, b: int, k: int, lr: float):
        dev = w_in.device
        self.cen = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self.neg = torch.zeros((b, k), dtype=torch.int64, device=dev)
        sgd_step(w_in.clone(), w_out.clone(), self.cen, self.pos, self.neg, lr)
        self.step = graphs.Captured(lambda: sgd_step(
            w_in, w_out, self.cen, self.pos, self.neg, lr))

    def __call__(self, cen, pos, neg) -> torch.Tensor:
        self.cen.copy_(cen)
        self.pos.copy_(pos)
        self.neg.copy_(neg)
        return self.step.replay().clone()


class Word2Vec(Estimator, HasInputCol, HasOutputCol):
    """Fit skip-gram word vectors over a column of texts/token lists."""

    vectorSize = Param("vectorSize", "Embedding dimension", 32, lambda v: v > 0, int)
    windowSize = Param("windowSize", "Context window radius", 3, lambda v: v > 0, int)
    minCount = Param("minCount", "Min word frequency kept in the vocab", 2,
                     lambda v: v >= 1, int)
    numIterations = Param("numIterations", "Passes over the pair table", 3,
                          lambda v: v > 0, int)
    numNegatives = Param("numNegatives", "Negative samples per pair", 4,
                         lambda v: v >= 1, int)
    stepSize = Param("stepSize", "SGD learning rate", 0.1, lambda v: v > 0,
                     float)
    batchSize = Param("batchSize", "Pairs per SGD step", 1024,
                      lambda v: v >= 1, int)
    seed = Param("seed", "RNG seed", 0, ptype=int)

    def fit(self, df: DataFrame) -> "Word2VecModel":
        col = df.column(self.get_or_throw("inputCol"))
        docs = [_tokens_of(v) for v in col]

        # vocabulary (host)
        counts: Dict[str, int] = {}
        for doc in docs:
            for t in doc:
                counts[t] = counts.get(t, 0) + 1
        vocab = sorted(w for w, c in counts.items()
                       if c >= self.get("minCount"))
        if not vocab:
            raise ValueError("Word2Vec: empty vocabulary "
                             "(all words below minCount)")
        index = {w: i for i, w in enumerate(vocab)}
        V, D = len(vocab), self.get("vectorSize")

        # skip-gram pair table (host)
        centers_np, contexts_np = _pair_table(
            [[index[t] for t in doc if t in index] for doc in docs],
            self.get("windowSize"))
        if not len(centers_np):
            raise ValueError("Word2Vec: no training pairs "
                             "(documents too short for the window)")

        # unigram^0.75 negative-sampling distribution (word2vec convention)
        freq = np.asarray([counts[w] for w in vocab], dtype=np.float64) ** 0.75
        neg_p = freq / freq.sum()

        rng = np.random.default_rng(self.get("seed"))
        B = min(self.get("batchSize"), len(centers_np))
        K = self.get("numNegatives")
        lr = self.get("stepSize")
        device = resolve_device()
        cdf = negative_cdf(neg_p, device)
        k_in = threefry.split(threefry.prng_key(self.get("seed"), device), 2)[0]
        w_in = threefry.normal(k_in, V * D).reshape(V, D) * 0.1
        w_out = torch.zeros((V, D), dtype=torch.float32, device=device)
        centers = torch.from_numpy(centers_np.astype(np.int64)).to(device)
        contexts = torch.from_numpy(contexts_np.astype(np.int64)).to(device)

        n_pairs = len(centers_np)
        steps = max(1, n_pairs // B)
        losses = []
        with _deterministic(device):
            step = (_CapturedStep(w_in, w_out, B, K, lr)
                    if device.type == "cuda" else
                    functools.partial(sgd_step, w_in, w_out, lr=lr))
            for _ in range(self.get("numIterations")):
                # steps = n_pairs // B, so every step takes exactly B pairs
                # (the ragged tail is dropped)
                sel = torch.from_numpy(rng.permutation(n_pairs)).to(
                    device)[:steps * B].view(steps, B)
                cen, ctx = centers[sel], contexts[sel]
                negs = draw_negatives(rng, cdf, (steps, B, K))
                for s in range(steps):
                    losses.append(step(cen[s], ctx[s], negs[s]))
            if device.type == "cuda":
                step.step.release()
        #: the loss of every step of the last fit, on the host
        self.last_losses = torch.stack(losses).cpu().numpy()

        vectors = w_in.cpu().numpy()
        return Word2VecModel(
            inputCol=self.get("inputCol"), outputCol=self.get("outputCol"),
            vocab=list(vocab), vectors=vectors)


class Word2VecModel(Model, HasInputCol, HasOutputCol):
    """Average-of-word-vectors document embedding + synonym lookup."""

    vocab = ComplexParam("vocab", "Vocabulary (index order)")
    vectors = ComplexParam("vectors", "[V, D] embedding matrix")

    def _index(self) -> Dict[str, int]:
        return {w: i for i, w in enumerate(self.get_or_throw("vocab"))}

    def transform(self, df: DataFrame) -> DataFrame:
        index = self._index()
        vecs = np.asarray(self.get_or_throw("vectors"))
        dim = vecs.shape[1]

        def fn(p):
            col = p[self.get_or_throw("inputCol")]
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                ids = [index[t] for t in _tokens_of(v) if t in index]
                out[i] = (vecs[ids].mean(axis=0) if ids
                          else np.zeros(dim, dtype=np.float32))
            return out

        return df.with_column(self.get_or_throw("outputCol"), fn)

    def transform_schema(self, schema: Schema) -> Schema:
        out = schema.copy()
        out.types[self.get_or_throw("outputCol")] = ColType.VECTOR
        return out

    def find_synonyms(self, word: str, num: int = 5) -> List[tuple]:
        """Cosine top-k neighbors (Spark Word2VecModel.findSynonyms)."""
        index = self._index()
        if word.lower() not in index:
            raise KeyError(word)
        vecs = np.asarray(self.get_or_throw("vectors"), dtype=np.float64)
        norms = np.linalg.norm(vecs, axis=1) + 1e-12
        q = vecs[index[word.lower()]]
        sims = vecs @ q / (norms * (np.linalg.norm(q) + 1e-12))
        vocab = self.get_or_throw("vocab")
        order = np.argsort(-sims)
        out = [(vocab[i], float(sims[i])) for i in order
               if vocab[i] != word.lower()][:num]
        return out
