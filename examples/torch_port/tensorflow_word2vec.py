"""Word2vec (skip-gram, NCE loss) on horovod_tpu_torch's TensorFlow
binding: the sparse-gradient path.

Counterpart of examples/tensorflow_word2vec.py. Embedding-lookup
gradients are ``tf.IndexedSlices``, and ``hvd.DistributedGradientTape``
reduces them through the sparse path: an allgather of values and
indices across ranks, not a dense allreduce (upstream:
tensorflow/__init__.py:62-73). ``--sparse-as-dense`` densifies them to
compare. A synthetic corpus (a Zipf token stream) keeps it hermetic; the
engine runs on the card by default, on the CPU with ``--device cpu``.
Prints a JSON summary (losses and gradient kinds) as its last line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

parser = argparse.ArgumentParser()
parser.add_argument("--vocab-size", type=int, default=2000)
parser.add_argument("--embedding-dim", type=int, default=64)
parser.add_argument("--num-sampled", type=int, default=16)
parser.add_argument("--window", type=int, default=2)
parser.add_argument("--batch-size", type=int, default=128)
parser.add_argument("--steps", type=int, default=20)
parser.add_argument("--sparse-as-dense", action="store_true", default=False)
parser.add_argument("--device", default="cuda",
                    help="the engine's device: cuda (default) or cpu")
args = parser.parse_args()


def synthetic_skipgrams(rng, n, vocab, window):
    """Zipf token stream -> (center, context) pairs, like the reference's
    generate_batch over text8."""
    stream = np.minimum(rng.zipf(1.3, n + 2 * window), vocab - 1)
    centers, contexts = [], []
    for i in range(window, n + window):
        for off in range(-window, window + 1):
            if off != 0:
                centers.append(stream[i])
                contexts.append(stream[i + off])
    return np.array(centers, np.int64), np.array(contexts, np.int64)


def main():
    hvd.init(device=args.device)
    rng = np.random.default_rng(1234 + hvd.rank())

    embeddings = tf.Variable(
        tf.random.uniform([args.vocab_size, args.embedding_dim], -1.0, 1.0,
                          seed=42))
    nce_weights = tf.Variable(
        tf.random.truncated_normal([args.vocab_size, args.embedding_dim],
                                   stddev=1.0 / np.sqrt(args.embedding_dim),
                                   seed=42))
    nce_biases = tf.Variable(tf.zeros([args.vocab_size]))
    variables = [embeddings, nce_weights, nce_biases]
    opt = tf.keras.optimizers.SGD(0.05 * hvd.size())

    hvd.broadcast_variables(variables, root_rank=0)

    losses = []
    for step in range(args.steps):
        centers, contexts = synthetic_skipgrams(
            rng, args.batch_size, args.vocab_size, args.window)
        labels = contexts[:, None]
        with tf.GradientTape() as tape:
            embed = tf.nn.embedding_lookup(embeddings, centers)
            loss = tf.reduce_mean(tf.nn.nce_loss(
                weights=nce_weights, biases=nce_biases, labels=labels,
                inputs=embed, num_sampled=args.num_sampled,
                num_classes=args.vocab_size))

        tape = hvd.DistributedGradientTape(
            tape, sparse_as_dense=args.sparse_as_dense)
        grads = tape.gradient(loss, variables)
        # embedding gradients arrive as IndexedSlices unless densified
        kinds = ["sparse" if isinstance(g, tf.IndexedSlices) else "dense"
                 for g in grads]
        opt.apply_gradients(zip(grads, variables))
        if step % 5 == 0 and hvd.rank() == 0:
            print(f"Step {step}  loss {float(loss):.4f}  grads={kinds}")
        losses.append(float(loss))

    if hvd.rank() == 0:
        norm = float(tf.norm(embeddings))
        print(f"Final embedding norm: {norm:.3f}")
    summary = {"example": "tensorflow_word2vec", "rank": hvd.rank(),
               "losses": losses, "grads": kinds}
    hvd.shutdown()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
