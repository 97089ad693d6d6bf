"""Train Spann3R with the PyTorch port:

    python -m spann3r_torch.train --train_dataset "1000 @ SynthRoom(...)" \
        [--test_dataset ...] [--output_dir ...] [--device cpu]

The flags are those of the JAX package's train.py, plus --device (default
cuda; raises without a card). On N cards of one host, one process each:

    python -m torch.distributed.run --nproc_per_node N -m spann3r_torch.train \
        --train_dataset ... [--model_axis M] [--fsdp 1]

(NCCL; with --device cpu, gloo on the CPU). --batch_size is per data rank;
--model_axis M splits each large block over M ranks and must divide N.
"""
from .training import get_args_parser, train


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        "Spann3R training (PyTorch port)", parents=[get_args_parser()])
    train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
