"""Finetune CroCo on stereo matching or optical flow (ref
croco/stereoflow/train.py CLI):

    python -m spann3r_torch.stereoflow_train {stereo,flow} --dataset ...
        --output_dir ... (--pretrained CKPT | --model 'CroCoNet(...)')
        [--device cpu]
"""
from .stereoflow.driver import get_args_parser, main

if __name__ == "__main__":
    main(get_args_parser().parse_args())
