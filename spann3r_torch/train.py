"""Train Spann3R with the PyTorch port:

    python -m spann3r_torch.train --train_dataset "1000 @ SynthRoom(...)" \
        [--test_dataset ...] [--output_dir ...] [--device cpu]

The flags are those of the JAX package's train.py, plus --device (default
cuda; raises without a card). One process: --model_axis > 1 and --fsdp 1
raise (multi-process training is not ported yet).
"""
from .training import get_args_parser, train


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        "Spann3R training (PyTorch port)", parents=[get_args_parser()])
    train(parser.parse_args(argv))


if __name__ == "__main__":
    main()
