"""The port's runnable examples, the counterparts of the JAX package's
`examples/train.py` and `examples/zero_shot.py`:

    python -m xclip_tpu_torch.examples.train [steps] [metrics.jsonl] \
        [--aux|--filip] [--device cpu]
    python -m xclip_tpu_torch.examples.zero_shot [--device cpu]

Both run on the card unless `--device cpu` is given."""
