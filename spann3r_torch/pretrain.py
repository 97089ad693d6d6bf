"""CroCo pretraining with the PyTorch port:

    python -m spann3r_torch.pretrain --data_dir <dir holding habitat_release>
        [--model "CroCoNet(...)"] [--output_dir ...] [--device cpu]

The flags are those of the JAX package's pretrain.py, plus --device
(default cuda; raises without a card). The pairs come from
<data_dir>/habitat_release/pairs.txt (`datasets.pairs.
parse_and_cache_all_pairs` writes it; `habitat_gen.scripts` renders
the pairs). On N cards of one host, one process each:

    python -m torch.distributed.run --nproc_per_node N -m spann3r_torch.pretrain ...

(NCCL; with --device cpu, gloo on the CPU). --batch_size is per rank.
"""
from .pretraining import get_args_parser, main as _main


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        "CroCo pretraining (PyTorch port)", parents=[get_args_parser()])
    return _main(parser.parse_args(argv))


if __name__ == "__main__":
    main()
