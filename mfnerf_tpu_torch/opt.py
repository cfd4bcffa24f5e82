"""The command line: a copy of ``mfnerf_tpu/opt.py``'s flag surface.

The same 52 flags, with the JAX package's names, defaults and choices, so
the reference's scripts (``benchmarking/benchmark_synthetic_nerf*.sh``) run
against the port unchanged. Flags marked ``[tpu]`` there keep their
defaults here. ``--s_flat`` and ``--pool_a`` change which samples a
training step keeps, and the port honours them (``models/rendering.py``).
Those that only choose a TPU formulation (``TPU_ONLY``) are parsed and
ignored: ``train.main`` prints one line for each that is set to another
value.
"""
import argparse

# [tpu] formulation flags: name -> default. The port has no counterpart
# (ROADMAP, Queue 1, "Do not port"); a non-default value is reported and
# ignored.
TPU_ONLY = {"wavefront": "auto", "multihost": False}


def get_opts(argv=None):
    """Parse ``argv`` (default: ``sys.argv[1:]``) into a Namespace."""
    parser = argparse.ArgumentParser()

    # dataset parameters
    parser.add_argument('--root_dir', type=str, required=True,
                        help='root directory of dataset')
    parser.add_argument('--dataset_name', type=str, default='nsvf',
                        choices=['nerf', 'nsvf', 'colmap', 'nerfpp', 'rtmv'],
                        help='which dataset to train/test')
    parser.add_argument('--split', type=str, default='train',
                        choices=['train', 'trainval', 'trainvaltest'],
                        help='use which split to train')
    parser.add_argument('--downsample', type=float, default=1.0,
                        help='downsample factor (<=1.0) for the images')

    # model parameters
    parser.add_argument('--scale', type=float, default=0.5,
                        help='scene scale (whole scene must lie in '
                             '[-scale, scale]^3')
    parser.add_argument('--use_exposure', action='store_true', default=False,
                        help='whether to train in HDR-NeRF setting')

    # loss parameters
    parser.add_argument('--distortion_loss_w', type=float, default=0,
                        help='weight of distortion loss (see losses.py), 0 '
                             'to disable (default); a good value is 1e-3 '
                             'for real scenes and 1e-2 for synthetic ones')

    # training options
    parser.add_argument('--batch_size', type=int, default=8192,
                        help='number of rays in a batch')
    parser.add_argument('--ray_sampling_strategy', type=str,
                        default='all_images',
                        choices=['all_images', 'same_image'],
                        help='all_images: uniformly from all pixels of ALL '
                             'images; same_image: uniformly from all pixels '
                             'of a SAME image')
    parser.add_argument('--num_epochs', type=int, default=30,
                        help='number of training epochs')
    parser.add_argument('--num_gpus', type=int, default=1,
                        help='number of GPUs for data parallelism (one '
                             'rank a card, parallel/dist.py)')
    parser.add_argument('--lr', type=float, default=1e-2,
                        help='learning rate')
    # experimental training options
    parser.add_argument('--optimize_ext', action='store_true', default=False,
                        help='whether to optimize extrinsics')
    parser.add_argument('--pose_lr', type=float, default=1e-6,
                        help='learning rate of the dR/dT pose refinement '
                             '(--optimize_ext)')
    parser.add_argument('--random_bg', action='store_true', default=False,
                        help='whether to train with random bg color (real '
                             'scene only) to avoid objects with black color '
                             'to be predicted as transparent')

    # validation options
    parser.add_argument('--eval_lpips', action='store_true', default=False,
                        help='evaluate lpips metric (needs '
                             '--lpips_weights)')
    parser.add_argument('--val_only', action='store_true', default=False,
                        help='run only validation (need to provide ckpt_path)')
    parser.add_argument('--no_save_test', action='store_true', default=False,
                        help='whether to save test image and video')

    # misc
    parser.add_argument('--exp_name', type=str, default='exp',
                        help='experiment name')
    parser.add_argument('--ckpt_path', type=str, default=None,
                        help='pretrained checkpoint to load (including '
                             'optimizers, etc)')
    parser.add_argument('--weight_path', type=str, default=None,
                        help='pretrained checkpoint to load (excluding '
                             'optimizers, etc)')

    # network config
    parser.add_argument('--grid', type=str, default='Hash',
                        choices=['Hash', 'Window', 'MixedFeature', 'LowRank'],
                        help='Encoding scheme: Hash/Window/MixedFeature '
                             '(reference parity) or LowRank (the hat-basis '
                             'CP encoding, see ops/lowrank.py)')
    parser.add_argument('--L', type=int, default=16,
                        help='Encoding hyper parameter L')
    parser.add_argument('--F', type=int, default=2,
                        help='Encoding hyper parameter F')
    parser.add_argument('--T', type=int, default=19,
                        help='Encoding hyper parameter T')
    parser.add_argument('--N_min', type=int, default=16,
                        help='Encoding hyper parameter N_min')
    parser.add_argument('--N_max', type=int, default=2048,
                        help='Encoding hyper parameter N_max')
    parser.add_argument('--N_tables', type=int, default=1,
                        help='Number of hash tables')

    parser.add_argument('--rgb_channels', type=int, default=64,
                        help='rgb network channels')
    parser.add_argument('--rgb_layers', type=int, default=2,
                        help='rgb network layers')

    parser.add_argument('--seed', type=int, default=1337,
                        help='random seed')

    # ------------------------------------------ the JAX package's extras
    parser.add_argument('--s_max_train', type=int, default=64,
                        help='static per-ray sample budget (train)')
    parser.add_argument('--s_max_test', type=int, default=256,
                        help='static per-ray sample budget (test)')
    parser.add_argument('--test_chunk', type=int, default=16384,
                        help='rays per test-render chunk')
    parser.add_argument('--lpips_weights', type=str, default=None,
                        help='npz with VGG16+LPIPS weights (--eval_lpips; '
                             'utils/lpips.py)')
    parser.add_argument('--profile', action='store_true', default=False,
                        help='trace 48 training steps with torch.profiler '
                             'into logs/<dataset>/<exp>/profile first')
    parser.add_argument('--bf16', action='store_true', default=False,
                        help='bfloat16 matmul compute')
    parser.add_argument('--lr_levels', type=int, default=8,
                        help='LowRank: number of resolution levels')
    parser.add_argument('--lr_rank', type=int, default=16,
                        help='LowRank: CP rank per level')
    parser.add_argument('--lr_frames', type=int, default=2,
                        help='LowRank: rotated coordinate frames')
    parser.add_argument('--lr_k_min', type=int, default=32,
                        help='LowRank: coarsest 1D resolution')
    parser.add_argument('--lr_k_max', type=int, default=512,
                        help='LowRank: finest 1D resolution')
    parser.add_argument('--lr_fused', type=int, default=1,
                        help='LowRank: fused nested-level evaluation (levels '
                             'snapped to a nested 2^m+1 ladder, one hat '
                             'product a frame, csrc/hatmul.cu). 1 (default) '
                             'on; 0 the per-level fp32 path')
    parser.add_argument('--hash_grad_samples', type=int, default=8,
                        choices=[1, 2, 4, 8],
                        help='Hash/Window/MixedFeature grids: corners (of 8) '
                             'receiving the table gradient, sampled by '
                             'trilinear weight (unbiased). 8 = exact')
    parser.add_argument('--refresh_half', default=True,
                        action=argparse.BooleanOptionalAction,
                        help='occupancy refresh evaluates alternating '
                             'even/odd-Morton cell halves; --no-refresh_half '
                             'refreshes every cell')
    parser.add_argument('--grid_size', type=int, default=128,
                        help='occupancy grid resolution (reference fixes 128)')
    parser.add_argument('--max_samples', type=int, default=1024,
                        help='max marched samples per ray (reference fixes '
                             'MAX_SAMPLES=1024)')
    parser.add_argument('--steps_per_epoch', type=int, default=1000,
                        help='steps per epoch (reference fixes 1000; lower '
                             'for smoke tests)')
    parser.add_argument('--s_flat', type=int, default=16,
                        help='[tpu] flat sample budget: from step 512 a '
                             'batch keeps its first N*s_flat samples, '
                             'evaluated on a static buffer of that many '
                             'slots (0: every sample; forced to 0 at '
                             'several cascades)')
    parser.add_argument('--pool_a', type=int, default=4,
                        help='[tpu] the training march\'s stage-A grid is '
                             'the occupancy grid pooled pool_a cells to a '
                             'side (0: 2)')
    parser.add_argument('--wavefront', type=str, default='auto',
                        help='[tpu] wavefront test renderer of the JAX '
                             'package; parsed and ignored by the port')
    parser.add_argument('--multihost', action='store_true', default=False,
                        help='[tpu] multi-host JAX runs; parsed and ignored '
                             'by the port')

    return parser.parse_args(argv)
