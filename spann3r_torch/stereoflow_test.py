"""Evaluate a finetuned stereo or flow model with tiled inference (ref
croco/stereoflow/test.py CLI):

    python -m spann3r_torch.stereoflow_test --model OUTPUT_DIR
        --dataset ... [--save metrics pred visu] [--device cpu]
"""
from .stereoflow.driver import get_test_args_parser, test_main

if __name__ == "__main__":
    test_main(get_test_args_parser().parse_args())
