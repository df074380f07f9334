#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dfmir_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing one JSON line:
  1. device   the card (nvidia-smi name and power limit); TF32 off for
              convs and matmuls (device.float32_math, as every entry point
              of the port does), so every comparison is float32 to float32
  2. build    nvcc builds every kernel from dfmir_tpu_torch/csrc/
  3. kernel   each 2-D kernel against its plain PyTorch version on the card
              at the main paths' shapes and a few hard ones (forward max-abs
              <= 1e-5; backward dflow <= 1e-5, dsrc <= 1e-5 * max(1,
              max|dsrc|) of autograd and, two calls bitwise the same,
              bit-equal to the fixed-point sum warp2d_dsrc_fixed_plain, in a
              collapse and with more items than blocks too), timed with
              CUDA events beside its byte/op bound and the one PyTorch call
              that computes the same function, B2's device us at every
              case; a host-clock breakdown of one B1 call and one
              B2 call at (1,1,256,256), part by part, on the earlier launch
              path (rebuilt here) and on the lean path, and of each 3-D
              launcher at (1,3,80,80,80) beside the library calls; VecInt's
              2-D chain kernels (vecint2d_fwd bit-equal to the plain loop,
              saving its steps and not, its field in the clusters' shared
              memory or, at (1,2,512,512), in global memory; vecint2d_bwd
              within 1e-5 * max(1, max|dvec|) of autograd of it, bitwise
              the same over two calls and equal to
              vecint2d_bwd_fixed_plain; both at clusters of 8 and 16 blocks)
              beside two chains built here: 7 direct B1 / B2 launches
              with their adds, and the chain written with F.grid_sample;
              at the main cases each chain at nsteps 1..7 (a step's cost,
              the fixed cost)
  4. register the paper's model at full width (RegistrationConfig
              defaults: crop 256, ngf 64, resnet_9blocks, VxmDense
              (16,32,32,64,64,64)/(64,64,64,32,32,32,16), 7 integration
              steps), random weights from --seed with the flow head scaled so
              the field deforms: 4 pairs at B=1 through
              infer.register_pair_outputs as test.py serves them, kernel
              launches counted over that run (1 chain forward + 1 B1 a
              call), one pair against the same
              weights on the CPU (max-abs <= 1e-3), then ms/pair at B=1 and
              pairs/s at B=8
  5. train    the joint translate-and-register step at the same full width
              (mlp_sample netF, 256 patches, nce_layers 0,4,8,12,16): one
              loss_fn on the card against the same weights and patch ids on
              the CPU (metrics within 1e-3 relative), then 1 warm-up and 3
              timed train_step calls at B=1, kernel launches counted over
              them (exactly 1 chain forward + 2 B1 and 1 chain backward + 2
              B2 a step), every metric
              finite and every parameter moved; a reduced-width step (crop
              64, ngf 8) card against CPU (metrics 1e-3 relative; gradients
              within 1e-2 * the network's max |g| of the CPU in float32 and
              1e-3 of the CPU in float64); then ms/step at B=1 and B=8
  fastcut     the paper model's training options at the same full width,
  gan         each from --seed with the flow head scaled: FastCUT (flip
  bf16        equivariance, nce_idt off, lambda_NCE 10: card vs CPU loss_fn
  dropout     at each coin within 1e-3 relative); lambda_GAN 1 (netD
              basic, lsgan: one two-phase step card vs CPU, D's metrics
              too, netD moving); compute_dtype bfloat16 (the flow head
              scaled to a field of about 0.1 px: register and loss_fn card
              vs the CPU's bf16 under the JAX suite's bf16 bars, fake_B
              0.1, pos_flow 1e-3, y_source 1e-2, metrics 1e-2 relative;
              master parameters float32; register ms at B=1 by CUDA events
              beside phase register's); each 1 warm-up + 3 timed steps at
              B=1 (ms/step beside phase train's, peak memory), launches
              exactly the CUT step's (bf16 register 1 + 1 a call);
              no_dropout False (2 counted steps, finite; the masks' keep
              rate 0.5 within 5 binomial sigmas on the card's generator;
              one seed twice the same masks; register bit-equal to the
              no_dropout=True model's)
  zoo         the network zoo at the same full width, one choice a run
              changed from RegistrationConfig(): netG unet_256 (taps
              0,2,4,6), resnet_cat (0,1,2,3), stylegan2 and smallstylegan2
              (1,2,3); netF sample, global_pool, reshape, strided_conv; netR
              vxm_transformer, vxm_dual; netD stylegan2, patchstylegan2,
              tilestylegan2 (lambda_GAN 1). Each run: one register call
              counted (1 chain forward + 1 B1), for the netG and netR runs
              against the same weights on the CPU (fake_B, y_source,
              pos_flow max-abs <= 1e-3); register ms (CUDA events, one
              call); 1 warm-up + 1 timed step counted (the CUT step's
              launches), every parameter moved but the noise weights no
              loss reaches, peak memory; one train step at the narrow width
              (crop 64, ngf 8; unet_256 at crop 256, resnet_cat at ngf 32)
              on the card and on the CPU: metrics 1e-3 relative (absolute
              below 1e-4), each network's gradients (netD's from its phase)
              within 1e-2 of its max |g| on the CPU. A line a run, then a
              summary line
  bf16_zoo    each of zoo's 13 choices in bfloat16 at the same full width
              (the flow head scaled to about 0.1 px): a register call
              counted (1 + 1), register ms (CUDA events, one call after a
              warm-up), 1
              warm-up + 1 timed step counted (the CUT step's launches),
              every master parameter and Adam moment float32 (netD's too),
              peak memory, each beside the float32 zoo run of this run; the
              narrow model card vs the CPU's bfloat16 (register under the
              bf16 bars, loss_fn metrics 1e-2 relative)
  cli         the 2-D command line in-process at the options' defaults
              (the paper's model at full width), in a temporary directory
              removed after, its prints in a log there: 16 train and 4
              test pairs of 256^2 PNGs written with utils/png.py in
              scripts/make_soak_data.py's layout; train.main at B=1 over 8
              pairs for 2 epochs (launches exactly 1 chain forward + 2 B1
              and 1 chain backward + 2 B2 a step, 1 chain forward + 3 B1 a
              compute_visuals, 1 chain forward + 1 B1 a
              registration_stats; finite losses; {1,2,latest}_net_{G,F,R}
              and _optim .pth, loss_log.txt, web/index.html); `latest`
              reloaded into a fresh task on the card bit-equal (weights and
              Adam state); --continue_train for one more epoch; `latest`
              registered on the card and on the CPU within 1e-3; test.main
              over the 4 test pairs (2 chain forwards + 3 B1 a pair; label
              values kept); evaluate.main (1 + 1 a pair; a finite summary);
              train.main --CUT_mode FastCUT and --lambda_GAN 1, 2 steps
              each (launches exact; the GAN run's `latest` with net_D and
              netD's Adam state reloaded bit-equal; test.main of it); two
              zoo models, 2 steps each (launches exact), `latest` reloaded
              bit-equal and test.main of one pair (2 chain forwards + 3
              B1): --netG unet_256 --nce_layers 0,2,4,6 --netR
              vxm_transformer --netF reshape, and --netG stylegan2
              --nce_layers 1,2,3 --netR vxm_dual --lambda_GAN 1 --netD
              tilestylegan2;
              train.main at B=8 for one epoch; then ms a step beside phase
              train's, data ms a step, PNG decode ms an image, checkpoint
              save and load ms and bytes, test and evaluate ms a pair
  6. kernel3d each 3-D trilinear kernel (forward, dflow, dsrc) against its
              plain version on the card: VecInt's self-warp (1,3,80,80,80),
              the 160^3 data warp (dflow only), an odd shape, a violent
              flow (x25 N(0,1)), a zero flow (an exact copy) and a collapse
              (flow 0.95 * (centre - p): thousands of targets a cell); bars
              forward and dflow 1e-5, dsrc 1e-5 * max(1, max|dsrc|) and,
              two calls bitwise the same, bit-equal to the plain binned sum
              (warp3d_dsrc_binned_plain); timed beside its byte/op bound,
              its plain version, grid_sample / grid_sampler_3d_backward and
              two yardsticks of dsrc built here from
              csrc/yardsticks/dsrc3d.cu (its phases as 4 plain launches; an
              int64 atomic scatter of the same terms), with device us a
              launch at the VecInt, 160^3 and joint-model cases; the
              3-D joint step's `registered` (1,1,128^3) and its stacked
              data warp (2,1,128^3), at fields of about a voxel; then
              VecInt's 3-D chain kernels (phase kernel_chain3d: (1,3,80^3)
              at +-10 and +-2 voxels (mild), a (2,3,80^3) pos/neg stack,
              the joint model's (1,3,64^3) and (2,3,64^3) pos/neg, first steps
              moving exactly 1, 2 and 3 voxels (the halo staged and past
              it), an odd shape, a x25 N(0,1) field, a collapse, 0-2
              steps; vecint3d_fwd bit-equal to the plain loop saving its
              steps and not, each step's bricks by halo and share of
              corners read from L2; vecint3d_bwd within 1e-5 * max(1,
              max|dvec|) and two calls bitwise the same) beside 7 direct
              B3 / B4 + B5 launches with their adds and the F.grid_sample
              chain
  7. vxm3d    the 3-D VoxelMorph engine at VxmConfig() defaults (160^3,
              enc (16,32,32,32), dec (32,32,32,32,32,16,16), 7 integration
              steps at half resolution, NCC 9^3), random weights from --seed
              with the flow head scaled: 4 register calls counted (1 chain
              forward + 1 B3 each), one register and one eval_step
              against the same weights on the CPU (1e-3), 1 warm-up + 5
              timed train steps counted (1 chain forward + 1 B3 + 1 chain
              backward + 1 B4 each, no B5; metrics finite, every parameter
              moved), 20 steps at lr 1e-3
              on one pair (the loss falls), a 64^3 step's gradients card vs
              CPU in float32 (1e-2 of each tensor's max |g|) and float64
              (1e-3); ms per register and per step at B=1, peak memory
  joint3d     the joint model in 3-D (RegistrationConfig(ndims=3,
              crop_size=128): ngf 64, resnet_9blocks, mlp_sample with 256
              patches, the default VxmDense, 7 steps at half resolution;
              128^3 as the netR's six stride-2 levels need a side 2^6
              divides), random weights from --seed with the flow head
              fitted to a field of 0.8 voxel (past a voxel y_source's
              border voxels are 0, and a patch of 0 makes NaN gradients
              in JAX, 1e7-scale ones here): 2 register_pair_outputs
              calls with a label volume
              counted (1 chain forward + 1 B3 each), register ms (CUDA
              events, one call), 1 warm-up + 1 timed step counted (1
              chain forward + 2 B3, 1 chain backward + 2 B4 + 1 B5:
              `registered`'s source gradient into netG), every parameter
              moved, peak memory, one step traced (device time by kernel,
              the idle share); a narrow model (32^3, ngf 8) card vs CPU
              (register 1e-3 max-abs, metrics 1e-3 relative, gradients
              1e-2 of each network's max |g|); 20 steps of the narrow
              model at 64^3 on one pair at lr 1e-3 (the total falls)
  bf16_3d     the same 3-D model in bfloat16 (the flow head fitted to a
              field of 0.05 voxel): register and 1 + 2 steps counted and
              timed beside joint3d's, master parameters and Adam state
              float32, peak
              memory; the narrow model card vs the CPU's bfloat16 under
              the bf16 bars
  zoo3d       the same 3-D model with one choice of the 3-D zoo changed a
              run: netG unet_128 (taps 0,2,4,6) and unet_256 (at 256^3,
              the smallest cube it takes), netF global_pool and
              strided_conv (at 64^3: its PatchNCE logits, the square of
              about 27,000 locations a tap, do not fit beside the step at
              128^3), netR vxm_dual, netD basic and pixel (lambda_GAN 1, a
              two-phase step); each in float32 (the flow head fitted to
              0.8 voxel; 1 + 1 steps) and bf16 (0.05 voxel; 1 + 1 steps):
              a register_pair_outputs call counted (1 chain forward + 1
              B3), register ms (CUDA events, one call), the steps
              counted (1 + 2 forward, 1 chain backward + 2 B4 + 1 B5; the
              D phase none), every parameter moved (netD's too; a tap of
              one location leaves its MLP a zero gradient, checked), master
              parameters and Adam state float32, peak memory; the narrow
              model card vs CPU (32^3; unet_128 at 128^3, strided_conv at
              16^3, unet_256 held by unet_128's): float32 register 1e-3
              max-abs, a train step's metrics 1e-3 relative and each
              network's gradients 1e-2 of its max |g| (netD's from its
              phase), bf16 register and loss_fn at the bf16 bars
  8. profile  (--profile only) device time by kernel and by conv shape
              over register calls, 2-D and 3-D train steps, netG / netR
              times, register calls with cuDNN's autotuner on, and each
              kernel's device time a launch beside grid_sampler_2d / _3d
  cli3d       the 3-D command line in-process at the task's defaults
              (--model vxm --dataset_mode volume: 160^3, B=1, NCC 9^3,
              enc (16,32,32,32), dec (32,32,32,32,32,16,16)), in a
              temporary directory removed after: 4 train and 2 test pairs
              of 160^3 .npy volumes with label volumes, written by this
              script's numpy copy of scripts/make_soak_data.py --ndims 3;
              train.main for 2 epochs of 4 steps (launches exactly 1 chain
              forward + 1 B3 + 1 chain backward + 1 B4 and no B5 a step,
              1 chain forward + 1 B3 a get_current_visuals and a
              registration_stats call; finite losses; {1,2,latest}_net_R
              and _optim .pth, loss_log.txt, web/index.html); `latest`
              reloaded into a fresh task on the card bit-equal (weights,
              Adam state, step); --continue_train for one more epoch;
              `latest` registered on the card and on the CPU within 1e-3;
              evaluate.main --ndims 3 over the 2 test pairs (1 + 1 a pair;
              the label warp is nearest, the plain version; a finite
              summary; warped label values within the input's); then ms a
              step beside phase vxm3d's, data ms a step, checkpoint save
              and load ms and bytes, evaluate ms a pair and its Dice /
              HD95 part
  dp          data parallelism (dfmir_tpu_torch/parallel/) at the same
              full width, 2 ranks sharing the one card over gloo (each its
              own process and CUDA context), global B=4, 2 a rank: one step
              against one process's B=4 step on the card (metrics 1e-3
              relative; gradients 1e-2 of each network's max |g|; after
              Adam only first-step sign flips, > 99% of components within
              1e-5), then 3 timed steps; the ranks' parameters and Adam
              state bit-equal after every step; each rank's launches a
              step exactly the CUT step's; one 2-rank step each of FastCUT
              and lambda_GAN 1; ms a step beside one process's B=4 step,
              each rank's peak memory
  dp_nccl     one rank in an NCCL group on the card (B=2, 2 steps, the
              second timed): the all-reduce over one rank gives every
              gradient back bit for bit, the first step's metrics equal one
              process's bit for bit, gradients and parameters within phase
              dp's bars (the plain step is not bitwise reproducible on the
              card: two runs of it measured beside); NCCL across cards is
              not run (one card)
  dp3d        VxmConfig() at 160^3 over 2 ranks on the card (gloo), B=1 a
              rank, against one process's B=2 step (total 1e-3 relative,
              gradients 1e-2 of each tensor's max |g|, the sign-flip rule),
              replicas bit-equal, launches a step 1 + 1 + 1 + 1 and no B5;
              ms a step, peak memory
  spatial3d   JAX's spatial mesh axis: B3 and B4 on slabs (the 80 planes
              from z0 0 and 80 of a (1,1,160^3) source, a +-2 voxel field)
              bit-equal to the whole-volume launches' rows and within 1e-5
              of their plain versions with z0; then VxmConfig() at 160^3
              split along D over 2 ranks (1 x 2, B=1) and 4 ranks (2 x 2,
              global B=2; 1 x 4, B=1, netR's fourth encoder level of 10
              planes gathered, the level printed) sharing the card over
              gloo, in one launch of 4 ranks (the 1 x 2 mesh its first
              two), each against one
              process on the whole batch: register's slabs put together
              (y_source, pos_flow) <= 1e-5 max-abs, the metrics of 2 steps
              1e-5 relative, gradients 1e-2 of each tensor's max |g| (the
              sign-flip rule), replicas bit-equal, a rank's launches a
              step 1 + 1 + 1 + 1 and no B5, a register call 1 + 1; ms a
              step and a register, peak memory, the bytes sent and the
              host seconds in the exchanges a step, by rank
  spatial_joint (run right after kernel_chain, while this process holds
              little of the card: its two 3-D ranks take ~33 GB each)
              the joint model on slabs: B1 on the 128-row halves of a
              256^2 source (0.0 from the whole image's rows, 1e-5 from
              its plain version) and B5 on the 64-plane halves of a 128^3
              volume (the slabs' int64 sums, in the fixed point of max|g|
              over the whole cotangent, 0.0 from the whole-volume B5,
              twice the same, equal to the plain slab sums), and B2 on
              the 128-row halves of a 256^2 image at C 1 and 2 (dflow 0.0
              from the whole image's rows and 1e-5 from its plain version;
              the slabs' int64 sums, in each item's fixed point of max|g|
              over the whole cotangent, 0.0 from the whole image's B2
              dsrc, twice the same, equal to the plain slab sums), each
              timed beside the whole launch; then RegistrationConfig() at
              256^2 split along H over 2 and 4 ranks (register and 2
              steps), the graft's RegistrationConfig(crop_size=64,
              num_patches=64) over 2 (register and 1 step; netR's sixth
              level gathered) and RegistrationConfig(ndims=3,
              crop_size=128) along D over 2 (register and 2 steps), in one
              launch of 4 ranks sharing the card (gloo), B=1, against one
              process run first in a launch of its own: register's slabs
              put together (fake_B, idt_B, y_source, pos_flow) <= 1e-4
              max-abs; the steps' metrics 1e-5 relative (the second from
              the one process's state after the first), the first step's
              gradients 1e-2 of each tensor's max |g| (a norm-fed conv
              bias: its network's; at 2-D the ranks and the one process
              in float64 as well, held so tensor by tensor, the float32
              ones network by network, the float32 one process's own
              distance from float64 printed) and its update under the
              first-step sign-flip rule, replicas bit-equal; a rank's
              launches exact (a register 1 + 1; a 2-D step 1 + 2 and 1 +
              2, a 3-D step 1 + 2 and 1 + 2 + 1); ms, peak memory, bytes
              and host seconds in the exchanges, by rank
  spatial_options (run right after spatial_joint) the paper model's
              training options on slabs at RegistrationConfig()'s full
              width, B=1 a data rank: over 2 ranks each alone (bfloat16
              with register, FastCUT at each coin, dropout, the GAN phase
              with netD basic, no_antialias_up), all-negatives PatchNCE
              over 2 x 2 (global B=2), bfloat16 + FastCUT + dropout + the
              GAN phase over 1 x 4, and the 3-D joint model in bfloat16
              at 128^3 over 1 x 2 (register and 2 steps), in one launch
              of 4 ranks sharing the card (gloo), against one process run
              first in a launch of its own: register within the bf16 bars;
              the steps' metrics 1e-5 relative (bfloat16 1e-2; with the
              GAN phase D, D_fake, D_real and G_GAN too), the float32
              first step's gradients 1e-2 of each network's and 5e-2 of
              each tensor's max |g| (netD's too) and its update under the
              sign-flip rule, every rank's parameters and Adam states
              (netD's too) bit-equal; a rank's launches exact (a 2-D step
              1 + 2 and 1 + 2 with any option, the D phase none; a 3-D
              step 1 + 2 and 1 + 2 + 1); ms a step and netD's forward and
              backward alone, peak memory, bytes and host seconds in the
              exchanges, by rank
  spatial_zoo (run right after spatial_options) the 2-D-only generators
              on slabs at RegistrationConfig()'s full width with the netG
              named, B=1 a data rank, register and 2 steps each: netG
              resnet_cat (taps 0,1,2,3) over 1 x 2 and 1 x 4; stylegan2
              (taps 1,2,3) with the GAN phase and netD stylegan2 over 1 x
              2, smallstylegan2 with netD tilestylegan2 over 1 x 4,
              stylegan2 with netD patchstylegan2 over 2 x 2 (global B=2),
              stylegan2 in bfloat16 over 1 x 2; in one launch of 4 ranks
              sharing the card (gloo), against one process run first in a
              launch of its own, at spatial_options' bars (register 1e-4
              max-abs in float32, the bf16 bars in bfloat16; G_GAN and
              D_fake 3e-4 relative with netD stylegan2 or tilestylegan2,
              whose one linear unit an image or tile carries float32's
              spread: the one process's own, each GAN run twice, printed
              beside it); a rank's
              launches exact (a step 1 + 2 and 1 + 2, a register 1 + 1);
              ms a step and netD's forward and backward alone, peak
              memory, bytes and host seconds in the exchanges, by rank
  dp_cli      train.main through the launcher on [cuda:0, cuda:0] (gloo) on
              phase cli's PNG pairs: 2 steps at B=2, 1 a rank; the one
              set of files a run writes, a loss-log line a print, once;
              each rank's launches train.main's derived counts; `latest`
              loaded on the card bit-equal to rank 1's final weights
  augment     ops/augment.py at full size: augment of a (8,1,256,256)
              batch and a (1,1,160^3) volume with a 4-label map, each call
              counted (1 chain forward at the SVF's max(s // 8, 2) an axis
              and 5 steps + 1 B1 / B3; the nearest label warp the plain
              gather); labels only their values; the same draws on the
              card and the CPU (image and flow max-abs <= 1e-4); ms a call
              (CUDA events, median of 20), with and without the label;
              peak memory.  kernel and kernel_chain3d also hold the chains
              at augment's fields (8^2, 2^2, 25^2, 32^2; 20^3, 2^3 at 5
              steps) against the plain loop
  affine      nets/affine_net.py's AffineRegistration at (8,1,256,256)
              (NCC) and (1,1,160^3) (L2) on a pair made by a known small
              random affine: 5 Adam steps at lr 1e-4, the loss falling;
              card vs CPU the first step from the initial weights and the
              second from the card's weights after the first (loss 1e-3
              relative, gradients 1e-2 of the network's max |g|, every
              tensor reached at the second); no kernel launch
              (the affine warp samples absolute coordinates with the plain
              gather, as JAX's XLA path); ms a step, peak memory
  losses      every losses/registry.py name on the card against the CPU at
              the main paths' shapes (256^2 images, (8,4,256,256) logits,
              256 patches of 256, (8,2,256,256) flows, 30^2 netD maps),
              smooth_loss_3d and NMI at 160^3, NT-Xent: 1e-4 of the
              largest value; deepsim with a 3-tap random conv extractor;
              ms a call
  cli_modes   train.main with --dataset_mode patient_site (3 sites x 4
              slices of 256^2 PNGs written here) and triplet (phase cli's
              layout), the default CUT model at full width, 2 steps each
              (launches exactly the CUT step's); the triplet run with
              --display_id 1 on a free localhost port, its page and loss
              history fetched from 127.0.0.1 while it serves (the step's
              losses in them); test.main on the triplet run, 2 pairs (2
              chain forwards + 3 B1 a pair)
Each phase's wall seconds follow it.  Then the kernels line (all nine
kernels, their launches by path: register, train, fastcut, gan,
bf16_register, bf16_train, dropout, zoo_register, zoo_train,
bf16_zoo_register, bf16_zoo_train (summed over the zoo's runs),
register3d, train3d, cli_train, cli_test, cli_fastcut, cli_gan,
cli_gan_test, cli_zoo_unet, cli_zoo_unet_test, cli_zoo_stylegan2,
cli_zoo_stylegan2_test, cli3d_train, cli3d_eval, joint3d_register,
joint3d_train, bf16_3d_register, bf16_3d_train, zoo3d_register,
zoo3d_train, bf16_zoo3d_register, bf16_zoo3d_train (summed over the 3-D
zoo's runs), dp, dp_fastcut, dp_gan,
dp_nccl, dp3d, spatial3d_register, spatial3d_train (the three meshes'
ranks), spatial_joint_register2d, spatial_joint_register3d,
spatial_joint_train2d, spatial_joint_train (the 2-D and the graft's
meshes' ranks; the 3-D mesh's), spatial_options_register2d,
spatial_options_register3d, spatial_options_train2d,
spatial_options_train3d, spatial_zoo_register, spatial_zoo_train (the
runs' ranks), dp_cli, augment2d, augment3d
(one call each),
cli_patient_site, cli_triplet, cli_triplet_test; a dp path's summed over
its ranks; B5's main path is joint3d_train), and last {"ok": true, "device": {...}}.  A rank that fails
fails its phase (its traceback in the error); nothing falls back to one
process or to the CPU.

    python3 chip_smoke.py --recipe3d [--recipe_epochs 600]

runs the device and build phases and phase recipe3d alone: the JAX
package's 3-D quality recipe (VXM3D_RECIPE_r05.json: 24 train and 12 test
64^3 pairs of make_soak_data.py --ndims 3 at its defaults, seed 0, flow
amplitude 6, texture 0.35; --image_loss mse --lambda_smooth 0.01 --lr
1e-3) trained through train.main on the card for --recipe_epochs epochs
(half at the initial rate, half decaying to zero), then `latest` scored by
evaluate.main --ndims 3; it prints the summary, ms a step and the wall
seconds, fails unless mean Dice after the warp exceeds Dice before, and
prints no result line.

    python3 chip_smoke.py --steps

runs the device and build phases and phase chain_steps alone: the chains
redesigned last (vecint2d_fwd, vecint2d_bwd, vecint3d_fwd) at nsteps
1..7 at their main cases, B2 with both gradients at the `registered`,
VecInt-step and collapse cases beside grid_sampler_2d_backward, and one
grid.sync() and one cluster barrier alone (csrc/yardsticks/sync.cu); it
prints no result line.  It calls the kernels through their wrappers
alone, so it also runs from an earlier commit's tree.

Exits non-zero without a CUDA card, and wherever a phase or an import
fails, its last stdout line then {"ok": false, "error": "<type>: <message>"}
(with "phase" where one failed); every failure propagates (its traceback on
stderr).  It imports the port from the checkout it runs in: copied alone
into an empty directory, or run with `python -P` from outside the repo, it
fails so, naming the import.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import math
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib


def fail_line(error, phase=None):
    """The result line of a failed run, on stdout: a run that fails is
    never silent there."""
    out = {"ok": False, **({"phase": phase} if phase else {}),
           "error": error if isinstance(error, str)
           else f"{type(error).__name__}: {error}"}
    print(json.dumps(out), flush=True)


# torch and the port: a checkout without them (the script copied alone, or
# run with `python -P` from outside the repo) fails with a result line
try:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dfmir_tpu_torch import evaluate as eval_cli
    from dfmir_tpu_torch import infer
    from dfmir_tpu_torch import test as test_cli
    from dfmir_tpu_torch import train as train_cli
    from dfmir_tpu_torch.data.transforms import to_array
    from dfmir_tpu_torch.data.volume import (crop_or_pad, load_volume,
                                             normalize_minmax)
    from dfmir_tpu_torch.device import float32_math
    from dfmir_tpu_torch.engine.config import RegistrationConfig
    from dfmir_tpu_torch.engine.registration import RegistrationModel
    from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
    from dfmir_tpu_torch.losses import nt_xent_loss, smooth_loss_3d
    from dfmir_tpu_torch.losses.registry import DICT_LOSSES, get_loss
    from dfmir_tpu_torch.metrics.image import deepsim
    from dfmir_tpu_torch.models.registration import RegistrationTask
    from dfmir_tpu_torch.models.vxm import VxmTask
    from dfmir_tpu_torch.nets.affine_net import AffineRegistration
    from dfmir_tpu_torch.nets.resnet_gen import Dropout
    from dfmir_tpu_torch.ops import _build, integrate, warp_cuda
    from dfmir_tpu_torch.ops import augment as augment_ops
    from dfmir_tpu_torch.ops.affine import affine_warp
    from dfmir_tpu_torch.ops.integrate import vecint, vecint_bwd_plain
    from dfmir_tpu_torch.ops.warp import (_kernel_takes, from_fixed,
                                          identity_grid, item_max_bits, warp,
                                          warp2d_dsrc_fixed_plain,
                                          warp3d_dsrc_binned_plain,
                                          warp_bwd_plain)
    from dfmir_tpu_torch.options import TestOptions, TrainOptions
    from dfmir_tpu_torch.parallel import checks
    from dfmir_tpu_torch.parallel.launch import backend_for, launch
    from dfmir_tpu_torch.parallel.mesh import (check_joint_slabs,
                                               first_whole_level)
    from dfmir_tpu_torch.utils.png import read_png, write_png
except Exception as err:
    fail_line(err)
    raise SystemExit(1)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5
PATH_TOL = 1e-3
FLOW_GAIN = 1e5          # flow head N(0, 1e-5) -> N(0, 1)
N_PAIRS = 4
# timing depth: 5 timed steps before phase zoo3d came, cut with the
# other phases' repetitions (the plain versions' timings, the register
# medians, the zoos' and the 3-D joint model's steps) to hold the script
# near 600 s beside it
TRAIN_STEPS = 3          # timed, after one warm-up step
# card vs CPU gradients: within GRAD_ENV * the network's max |g|, the JAX
# suite's cross-program bar: the CPU's own float32 gradient is ~5e-3 of
# netG's max |g| from float64 on this loss (the NCE's T = 0.07 softmax and
# netF's normalisation of near-zero projections amplify rounding).  The
# card against the CPU in float64: within GRAD_ENV_F64 (measured ~2e-5)
GRAD_ENV = 1e-2
GRAD_ENV_F64 = 1e-3
FWD, BWD = warp_cuda.FWD, warp_cuda.BWD
VF, VB = warp_cuda.VECINT_FWD, warp_cuda.VECINT_BWD
FWD3D, DFLOW3D, DSRC3D = warp_cuda.FWD3D, warp_cuda.DFLOW3D, warp_cuda.DSRC3D
VF3, VB3 = warp_cuda.VECINT3D_FWD, warp_cuda.VECINT3D_BWD
ZERO = dict.fromkeys(warp_cuda.LAUNCHES, 0)
# launches a 2-D register call makes: VecInt's chain + the y_source warp
REGISTER_LAUNCHES = {VF: 1, FWD: 1}
# a 2-D train step: the chain, the stacked source/target warp and
# `registered`, each forward and backward
STEP_LAUNCHES = {VF: 1, FWD: 2, VB: 1, BWD: 2}
NSTEPS = 7               # VecInt's integration steps
DEVICE = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=100, warmup=10):
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def smooth_field(shape, scale, gen, device):
    """(B, C, H, W) smooth random field of about +-scale."""
    B, C, H, W = shape
    coarse = torch.randn((B, C, max(H // 16, 2), max(W // 16, 2)),
                         generator=gen, device=device)
    return F.interpolate(coarse, size=(H, W), mode="bicubic",
                         align_corners=True) * scale


# ------------------------------------------------------------ phase 1
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    float32_math()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})
    return smi


# ------------------------------------------------------------ phase 2
YARD_DIR = _build.CSRC_DIR / "yardsticks"
_P, _I = ctypes.c_void_p, ctypes.c_int
YARD_SIGNATURES = {
    "dsrc3d.cu": {
        # (flow, g, dsrc, bins, B, C, D, H, W, phase, stream) -> cudaError_t
        "dfmir_yard_dsrc3d_phased": [_P] * 4 + [_I] * 6 + [_P],
        # (flow, g, dsrc, acc, B, C, D, H, W, stream) -> cudaError_t
        "dfmir_yard_dsrc3d_scatter64": [_P] * 4 + [_I] * 5 + [_P]},
    "sync.cu": {
        # (blocks, nsyncs, stream) -> cudaError_t
        "dfmir_yard_grid_sync": [_I, _I, _P],
        # (clusters, size, nsyncs, stream) -> cudaError_t
        "dfmir_yard_cluster_sync": [_I, _I, _I, _P]},
}
_yard = {}


def phase_build():
    """nvcc builds the port's library (ops/_build.py) and, at once, the
    yardsticks' libraries (csrc/yardsticks/, one each)."""
    lib = _build.library_path()
    existed = lib.exists()
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in YARD_SIGNATURES:
        out = _build.BUILD_DIR / f"libdfmir_yard_{name[:-3]}.{os.getpid()}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(YARD_DIR / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load()
    for name, (out, proc) in procs.items():
        output = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {YARD_DIR / name}:\n{output}")
        lib_y = ctypes.CDLL(str(out))
        for entry, argtypes in YARD_SIGNATURES[name].items():
            fn = getattr(lib_y, entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _yard[entry] = fn
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": not existed, "library": lib.name,
          "sources": [str(p.relative_to(_build.PKG_DIR.parent))
                      for p in _build.sources()],
          "yardsticks": [str((YARD_DIR / n).relative_to(
              _build.PKG_DIR.parent)) for n in YARD_SIGNATURES]})


def yard_dsrc3d(entry, flow, g):
    """A yardstick of B5 (csrc/yardsticks/dsrc3d.cu): returns a call that
    launches it on the current stream and returns its dsrc, its output and
    scratch allocated here once; ``call(p)`` launches phase p alone of the
    phased one."""
    B, C, D, H, W = g.shape
    dsrc = torch.empty_like(g)
    if entry == "phased":
        scratch = warp_cuda._bins3d(g, 1)
    else:
        scratch = torch.empty(g.numel() + 1, dtype=torch.int64,
                              device=g.device)
    fn = _yard[f"dfmir_yard_dsrc3d_{entry}"]
    d = g.get_device()

    def call(phase=-1):
        extra = (phase,) if entry == "phased" else ()
        err = fn(flow.data_ptr(), g.data_ptr(), dsrc.data_ptr(),
                 scratch.data_ptr(), B, C, D, H, W, *extra,
                 torch._C._cuda_getCurrentRawStream(d))
        if err:
            raise RuntimeError(f"yardstick {entry}: cudaError {err}")
        return dsrc

    return call


# ------------------------------------------------------------ phase 3
WARP_CASES = [
    # name, (B, C, H, W), flow scale (px), flow shift (px)
    ("vecint_step", (1, 2, 128, 128), 5.0, 0.0),   # one VecInt step
    ("y_source_b1", (1, 1, 256, 256), 5.0, 0.0),
    ("y_source_b8", (8, 1, 256, 256), 20.0, 0.0),
    ("mostly_outside", (2, 1, 128, 128), 40.0, 90.0),
    ("odd_shape", (3, 3, 67, 45), 3.0, 0.0),
]
MAIN_CASE = "y_source_b1"   # the single warp of a register call


def warp2d_bound(B, C, H, W):
    """Least time for the warp's work: flow read once, src read once, out
    written once; ~12 flops a pixel for coordinates and weights, 7 a
    channel for the corner sum."""
    nbytes = 4 * (B * 2 * H * W + 2 * B * C * H * W)
    flops = B * H * W * (12 + 7 * C)
    return bound(nbytes, flops)


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the larger of bytes over HBM's rate and
    float32 operations over the card's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def normalised_grid(flow):
    """grid_sample's normalised (x, y) grid for the pixel flow."""
    H, W = flow.shape[2:]
    locs = identity_grid((H, W), device=flow.device)[None] + flow
    return torch.stack([2 * (locs[:, 1] / (W - 1) - 0.5),
                        2 * (locs[:, 0] / (H - 1) - 0.5)], dim=-1)


def grid_sample_call(src, flow):
    """The one PyTorch call computing the same function (the yardstick):
    grid_sample on the flow's normalised coordinates, built beforehand."""
    grid = normalised_grid(flow)
    return lambda: F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def phase_kernel(seed, profile):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for name, (B, C, H, W), scale, shift in WARP_CASES:
        src = torch.randn((B, C, H, W), generator=gen, device=dev)
        flow = smooth_field((B, 2, H, W), scale, gen, dev) + shift
        out = warp_cuda.warp2d_cuda(src, flow)
        torch.cuda.synchronize()
        ref = warp(src, flow, impl="torch")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        library = grid_sample_call(src, flow)
        lib_err = float((library() - ref).abs().max())
        outside = float(((out == 0).float().mean()))
        bound_ms, bound_by = warp2d_bound(B, C, H, W)
        kernel = lambda: warp_cuda.warp2d_cuda(src, flow)  # noqa: E731
        row = {
            "case": name, "shape": [B, C, H, W], "flow_px": scale,
            "shift_px": shift, "max_abs_err": err,
            "zero_fraction": outside,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: warp(src, flow, impl="torch"),
                                reps=10, warmup=2),
            "library_ms": time_ms(library),
            "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if profile:
            row["device_us_per_launch"] = device_us(kernel, FWD)
            # cuDNN's grid sampler on 4-D input: every kernel of the call
            row["library_device_us_per_call"] = device_us(library)
        emit({"phase": "kernel", "kernel": FWD, **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp2d kernel disagrees with its plain "
                                 f"version on {name}: {err} > {KERNEL_TOL}")
        rows[name] = row
    return rows


BWD_CASES = [
    # name, (B, C, H, W), flow kind, flow scale (px; "collapse": the
    # factor), flow shift (px), dsrc wanted, src is flow
    ("vecint_step", (2, 2, 128, 128), "smooth", 5.0, 0.0, True, True),
    ("data_warp", (2, 1, 256, 256), "smooth", 5.0, 0.0, False, False),
    ("registered", (1, 1, 256, 256), "smooth", 5.0, 0.0, True, False),
    ("mostly_outside", (2, 1, 128, 128), "smooth", 40.0, 90.0, True, False),
    ("odd_shape", (3, 3, 67, 45), "smooth", 3.0, 0.0, True, False),
    # every pixel samples near the centre: thousands of terms a pixel
    ("collapse", (1, 1, 256, 256), "collapse", 0.95, 0.0, True, False),
    # more items than the card holds blocks: a block takes several items
    ("many_items", (2048, 2, 8, 8), "smooth", 2.0, 0.0, True, False),
]
MAIN_BWD_CASE = "registered"   # the backward of `registered = warp(fake_B,
                               # pos_flow)`, both gradients


def bwd_case_inputs(shape, kind, scale, shift, alias, gen, dev):
    """(src, flow, g) of a BWD_CASES case."""
    B, C, H, W = shape
    if kind == "collapse":
        flow = collapse_field((B, 2, H, W), scale, dev)
    else:
        flow = smooth_field((B, 2, H, W), scale, gen, dev) + shift
    src = flow if alias else torch.randn(shape, generator=gen, device=dev)
    return src, flow, torch.randn(shape, generator=gen, device=dev)


def warp2d_bwd_bound(B, C, H, W, need_dsrc, alias):
    """Least time for the backward's work: flow, src (once, if it is not
    the flow) and g read once, dflow and (if wanted) dsrc written once;
    ~12 flops a pixel for coordinates and weights, 14 a channel for dflow
    and 10 more for the dsrc scatter."""
    px, vals = B * H * W, B * C * H * W
    nbytes = 4 * (2 * px + (0 if alias else vals) + vals + 2 * px
                  + (vals if need_dsrc else 0))
    flops = px * 12 + vals * (14 + (10 if need_dsrc else 0))
    return bound(nbytes, flops)


def grid_sample_bwd_call(src, flow, g, need_dsrc):
    """The one PyTorch call computing the same function: the backward of
    grid_sample (aten::grid_sampler_2d_backward) on the flow's normalised
    grid, built beforehand.  Returns (call, its dflow in pixel units)."""
    H, W = flow.shape[2:]
    grid = normalised_grid(flow)

    def call():
        return torch.ops.aten.grid_sampler_2d_backward(
            g, src, grid, 0, 0, True, [need_dsrc, True])

    dgrid = call()[1]
    dflow = torch.stack([dgrid[..., 1] * (2 / (H - 1)),
                         dgrid[..., 0] * (2 / (W - 1))], dim=1)
    return call, dflow


def phase_kernel_bwd(seed, profile):
    """B2 against its plain version at BWD_CASES: dflow within 1e-5 of
    autograd; dsrc within 1e-5 * max(1, max|dsrc|) of it, bitwise the same
    over two calls and 0.0 from warp2d_dsrc_fixed_plain; timed beside its
    bound, its plain version and grid_sampler_2d_backward, with device us a
    launch at every case."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = {}
    for (name, (B, C, H, W), kind, scale, shift, need_dsrc,
         alias) in BWD_CASES:
        src, flow, g = bwd_case_inputs((B, C, H, W), kind, scale, shift,
                                       alias, gen, dev)
        dsrc, dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g, need_dsrc)
        dsrc2, dflow2 = warp_cuda.warp2d_bwd_cuda(src, flow, g, need_dsrc)
        torch.cuda.synchronize()
        ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, g, need_dsrc)
        torch.cuda.synchronize()
        err_dflow = float((dflow - ref_dflow).abs().max())
        dsrc_scale = (max(1.0, float(ref_dsrc.abs().max())) if need_dsrc
                      else 1.0)
        err_dsrc = (float((dsrc - ref_dsrc).abs().max()) if need_dsrc
                    else 0.0)
        if not need_dsrc and dsrc is not None:
            raise AssertionError(f"{name}: dsrc computed though not wanted")
        same = torch.equal(dflow, dflow2) and (
            not need_dsrc or torch.equal(dsrc, dsrc2))
        fixed_err = (float((dsrc - warp2d_dsrc_fixed_plain(flow, g))
                           .abs().max()) if need_dsrc else 0.0)
        library, lib_dflow = grid_sample_bwd_call(src, flow, g, need_dsrc)
        bound_ms, bound_by = warp2d_bwd_bound(B, C, H, W, need_dsrc, alias)
        kernel = lambda: warp_cuda.warp2d_bwd_cuda(  # noqa: E731
            src, flow, g, need_dsrc)
        row = {
            "case": name, "shape": [B, C, H, W], "flow_px": scale,
            "shift_px": shift, "need_dsrc": need_dsrc, "src_is_flow": alias,
            "max_abs_err_dflow": err_dflow, "max_abs_err_dsrc": err_dsrc,
            "dsrc_scale": dsrc_scale,
            "max_abs_err": max(err_dflow, err_dsrc),
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: warp_bwd_plain(
                src, flow, g, need_dsrc), reps=10, warmup=2),
            "library_ms": time_ms(library),
            "library_max_abs_err_dflow":
                float((lib_dflow - ref_dflow).abs().max()),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bit_reproducible": same, "fixed_max_abs_err": fixed_err,
            "device_us_per_launch": device_us(kernel, BWD),
        }
        if profile:
            row["library_device_us_per_call"] = device_us(library)
        emit({"phase": "kernel", "kernel": BWD, **row})
        if not (err_dflow <= KERNEL_TOL
                and err_dsrc <= KERNEL_TOL * dsrc_scale):
            raise AssertionError(
                f"warp2d backward kernel disagrees with its plain version on "
                f"{name}: dflow {err_dflow}, dsrc {err_dsrc} (scale "
                f"{dsrc_scale}) > {KERNEL_TOL}")
        if not same or fixed_err != 0.0:
            raise AssertionError(
                f"warp2d backward on {name}: two calls the same bits "
                f"{same}, dsrc {fixed_err} from warp2d_dsrc_fixed_plain")
        rows[name] = row
    return rows


# the earlier launch path, rebuilt here as it was, beside the lean one
def seed_launch(entry, src, *args):
    """The launch as ops/warp_cuda.py made it before the lean path: a
    device guard around a Python Stream object and the call."""
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def seed_warp2d(src, flow, counts):
    warp_cuda._check(src, flow, "warp2d_cuda", 2)
    out = torch.empty_like(src)
    seed_launch("dfmir_warp2d_fwd", src, src.data_ptr(), flow.data_ptr(),
                out.data_ptr(), *src.shape)
    counts[FWD] += 1
    return out


def seed_warp2d_bwd(src, flow, g, counts):
    warp_cuda._check(src, flow, "warp2d_bwd_cuda", 2)
    warp_cuda._check_g(g, src)
    dflow = torch.empty_like(flow)
    dsrc = torch.zeros_like(src)
    scratch = torch.empty(warp_cuda._scratch2d(*src.shape),
                          dtype=torch.int64, device=src.device)
    seed_launch("dfmir_warp2d_bwd", src, src.data_ptr(), flow.data_ptr(),
                g.data_ptr(), dsrc.data_ptr(), dflow.data_ptr(),
                scratch.data_ptr(), *src.shape)
    counts[BWD] += 1
    return dsrc, dflow


class SeedWarp2d(torch.autograd.Function):
    """Warp2dFunction's forward over the seed's launcher."""

    @staticmethod
    def forward(ctx, src, flow):
        ctx.save_for_backward(src, flow)
        return seed_warp2d(src, flow, {FWD: 0})

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError


def seed_warp(src, flow):
    """warp(src, flow) as it dispatched before the lean path."""
    if not _kernel_takes(src, flow, "bilinear"):
        raise AssertionError("the card's warp should take these tensors")
    return SeedWarp2d.apply(src.contiguous(), flow.contiguous())


def host_us(fn, calls=2000, warmup=50):
    """Mean host-clock microseconds of one call of ``fn`` over ``calls``
    calls (the enqueue, not the device's work), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def phase_host_path(seed):
    """The host path of one B1 call at y_source's (1,1,256,256) and one B2
    call at the `registered` case, part by part on the host clock: before
    the lean path (rebuilt here) and on it.  The parts are timed one by
    one; "rest" is the whole call less its parts (call overhead, Function
    .apply for warp).  Then the 3-D launchers (host_path3d)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    src = torch.randn((1, 1, 256, 256), generator=gen, device=dev)
    flow = smooth_field((1, 2, 256, 256), 5.0, gen, dev)
    g = torch.randn((1, 1, 256, 256), generator=gen, device=dev)
    out, dsrc, dflow = (torch.empty_like(t) for t in (src, src, flow))
    scratch = torch.empty(warp_cuda._scratch2d(*src.shape),
                          dtype=torch.int64, device=dev)
    lib = _build.load()
    fwd_fn, bwd_fn = lib.dfmir_warp2d_fwd, lib.dfmir_warp2d_bwd
    d = src.get_device()
    counts = dict(ZERO)
    stream = torch._C._cuda_getCurrentRawStream(d)
    fwd_args = (src.data_ptr(), flow.data_ptr(), out.data_ptr(), *src.shape)
    bwd_args = (src.data_ptr(), flow.data_ptr(), g.data_ptr(),
                dsrc.data_ptr(), dflow.data_ptr(), scratch.data_ptr(),
                *src.shape)

    def guard():
        with torch.cuda.device(src.device):
            pass

    def count():
        counts[FWD] += 1

    common = {
        "dispatch": lambda: _kernel_takes(src, flow, "bilinear"),
        "contiguous": lambda: (src.contiguous(), flow.contiguous()),
        "alloc_out": lambda: torch.empty_like(src),
        "args": lambda: (src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                         *src.shape),
        "count": count,
    }
    parts = {
        "before": dict(common, **{
            "check": lambda: warp_cuda._check(src, flow, "warp2d_cuda", 2),
            "load": _build.load,
            "guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream,
            "ctypes_launch": lambda: getattr(lib, "dfmir_warp2d_fwd")(
                *fwd_args, stream)}),
        "after": dict(common, **{
            "check": lambda: warp_cuda._device(src, flow, "warp2d_cuda", 2),
            "entry": lambda: getattr(_build.load(), "dfmir_warp2d_fwd"),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
            "device_test": lambda: d == torch._C._cuda_getDevice(),
            "ctypes_launch": lambda: fwd_fn(*fwd_args, stream)}),
    }
    launchers = {"before": lambda: seed_warp2d(src, flow, counts),
                 "after": lambda: warp_cuda.warp2d_cuda(src, flow)}
    warps = {"before": lambda: seed_warp(src, flow),
             "after": lambda: warp(src, flow)}
    bwd_parts = {
        "before": {
            "check": lambda: (warp_cuda._check(src, flow, "warp2d_bwd_cuda",
                                               2), warp_cuda._check_g(g, src)),
            "alloc_dflow": lambda: torch.empty_like(flow),
            "alloc_dsrc": lambda: torch.zeros_like(src),
            "load": _build.load, "guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream,
            "ctypes_launch": lambda: getattr(lib, "dfmir_warp2d_bwd")(
                *bwd_args, stream)},
        "after": {
            "check": lambda: (warp_cuda._device(src, flow, "warp2d_bwd_cuda",
                                                2), warp_cuda._check_g(g,
                                                                       src)),
            "alloc_dflow": lambda: torch.empty_like(flow),
            "alloc_dsrc": lambda: torch.empty_like(src),
            "alloc_scratch": lambda: torch.empty(
                warp_cuda._scratch2d(*src.shape), dtype=torch.int64,
                device=dev),
            "entry": lambda: getattr(_build.load(), "dfmir_warp2d_bwd"),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
            "device_test": lambda: d == torch._C._cuda_getDevice(),
            "ctypes_launch": lambda: bwd_fn(*bwd_args, stream)},
    }
    bwd_launchers = {
        "before": lambda: seed_warp2d_bwd(src, flow, g, counts),
        "after": lambda: warp_cuda.warp2d_bwd_cuda(src, flow, g)}
    library = grid_sample_call(src, flow)
    library_bwd, _ = grid_sample_bwd_call(src, flow, g, True)
    lines = {}
    for path in ("before", "after"):
        us = {k: host_us(fn) for k, fn in parts[path].items()}
        launcher_parts = sum(v for k, v in us.items()
                             if k not in ("dispatch", "contiguous"))
        us["launcher_total"] = host_us(launchers[path])
        us["launcher_rest"] = us["launcher_total"] - launcher_parts
        us["warp_total"] = host_us(warps[path])
        us["warp_rest"] = (us["warp_total"] - us["launcher_total"]
                           - us["dispatch"] - us["contiguous"])
        bus = {k: host_us(fn) for k, fn in bwd_parts[path].items()}
        bus["launcher_total"] = host_us(bwd_launchers[path])
        bus["launcher_rest"] = bus["launcher_total"] - sum(
            v for k, v in bus.items() if k != "launcher_total")
        lines[path] = {
            "B1_us": us, "B2_us": bus,
            "B1_launcher_ms_events": time_ms(launchers[path]),
            "B2_launcher_ms_events": time_ms(bwd_launchers[path])}
        emit({"phase": "host_path", "path": path,
              "what": ("the seed's launch path, rebuilt in chip_smoke.py"
                       if path == "before" else "ops/warp_cuda.py"),
              "case": "B1 y_source (1,1,256,256); B2 registered "
                      "(1,1,256,256), both gradients", **lines[path],
              "library_us": host_us(library),
              "library_bwd_us": host_us(library_bwd),
              "library_ms_events": time_ms(library),
              "library_bwd_ms_events": time_ms(library_bwd)})
    lines["3d"] = host_path3d(seed)
    return lines


HOST3D_SHAPE = (1, 3, 80, 80, 80)     # VecInt's field in a 3-D step


def host_path3d(seed):
    """The host path of each 3-D launcher at VecInt's (1,3,80,80,80) (a
    self-warp, and the chain's 7 steps), part by part on the host clock,
    beside the library calls on the same inputs, with each call's CUDA-event
    time and device time: why B3 trailed F.grid_sample host-timed while it
    matched it on the device.  200 calls a part, fewer than the launch queue
    holds, so the host never waits on the card."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    shape = HOST3D_SHAPE
    B, _, D, H, W = shape
    v = chain_field(shape, "smooth", 3.0, gen, dev)     # src is the flow
    g = torch.randn(shape, generator=gen, device=dev)
    _, steps = warp_cuda.vecint3d_fwd_cuda(v, NSTEPS, save=True)
    out, dflow, dsrc = (torch.empty_like(v) for _ in range(3))
    scratch = v.new_empty((2, *shape))
    bins1, bins = warp_cuda._bins3d(v, 1), warp_cuda._bins3d(v, NSTEPS)
    nbricks = warp_cuda._bricks3d(shape)
    maxes = torch.empty(nbricks, dtype=torch.int32, device=dev)
    lib = _build.load()
    d = v.get_device()
    stream = torch._C._cuda_getCurrentRawStream(d)
    args = {
        "dfmir_warp3d_fwd": (v.data_ptr(), v.data_ptr(), out.data_ptr(),
                             *shape, D, 0),
        "dfmir_warp3d_bwd_dflow": (v.data_ptr(), v.data_ptr(), g.data_ptr(),
                                   dflow.data_ptr(), *shape, D, 0),
        "dfmir_warp3d_bwd_dsrc": (v.data_ptr(), g.data_ptr(),
                                  dsrc.data_ptr(), bins1.data_ptr(), *shape,
                                  0),
        "dfmir_vecint3d_fwd": (v.data_ptr(), steps.data_ptr(),
                               steps.stride(0), out.data_ptr(),
                               maxes.data_ptr(), B, D, H, W, NSTEPS, 1, 0),
        "dfmir_vecint3d_bwd": (steps.data_ptr(), steps.stride(0),
                               g.data_ptr(), scratch.data_ptr(),
                               bins.data_ptr(), dsrc.data_ptr(), B, D, H, W,
                               NSTEPS, 0),
    }

    def parts(entry, check, **allocs):
        fn = getattr(lib, entry)
        return {"check": check, **allocs,
                "entry": lambda: getattr(_build.load(), entry),
                "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
                "device_test": lambda: d == torch._C._cuda_getDevice(),
                "ctypes_launch": lambda: fn(*args[entry], stream)}

    empty = lambda: torch.empty_like(v)  # noqa: E731
    alloc_bins = {"alloc_bins": lambda: warp_cuda._bins3d(v, 1)}
    launchers = {
        FWD3D: (parts("dfmir_warp3d_fwd",
                      lambda: warp_cuda._device(v, v, "warp3d_cuda", 3),
                      alloc_out=empty),
                lambda: warp_cuda.warp3d_cuda(v, v)),
        DFLOW3D: (parts("dfmir_warp3d_bwd_dflow",
                        lambda: (warp_cuda._device(
                            v, v, "warp3d_bwd_dflow_cuda", 3),
                                 warp_cuda._check_g(g, v)),
                        alloc_dflow=empty),
                  lambda: warp_cuda.warp3d_bwd_dflow_cuda(v, v, g)),
        DSRC3D: (parts("dfmir_warp3d_bwd_dsrc",
                       lambda: warp_cuda._device(
                           g, v, "warp3d_bwd_dsrc_cuda", 3),
                       alloc_dsrc=empty, **alloc_bins),
                 lambda: warp_cuda.warp3d_bwd_dsrc_cuda(v, g)),
        VF3: (parts("dfmir_vecint3d_fwd",
                    lambda: warp_cuda._device(v, v, "vecint3d_fwd_cuda", 3),
                    alloc_out=empty,
                    alloc_steps=lambda: warp_cuda.stack3d(v, NSTEPS),
                    alloc_maxes=lambda: torch.empty(
                        nbricks, dtype=torch.int32, device=dev)),
              lambda: warp_cuda.vecint3d_fwd_cuda(v, NSTEPS, save=True)),
        VB3: (parts("dfmir_vecint3d_bwd",
                    lambda: warp_cuda._device(g, g, "vecint3d_bwd_cuda", 3),
                    alloc_dvec=empty,
                    alloc_scratch=lambda: v.new_empty((2, *shape)),
                    alloc_bins=lambda: warp_cuda._bins3d(v, NSTEPS)),
              lambda: warp_cuda.vecint3d_bwd_cuda(steps, g)),
    }
    rows = {}
    for name, (split, launcher) in launchers.items():
        us = {k: host_us(fn, calls=200, warmup=20) for k, fn in split.items()}
        total = host_us(launcher, calls=200, warmup=20)
        rows[name] = {"us": us, "launcher_us": total,
                      "launcher_rest_us": total - sum(us.values()),
                      "ms_events": time_ms(launcher, reps=50),
                      "device_us": device_us(launcher, name)}
    library, _ = library3d_calls(v, v, g)
    lib_rows = {name: {"host_us": host_us(fn, calls=200, warmup=20),
                       "ms_events": time_ms(fn, reps=50),
                       "device_us": device_us(fn, "grid_sampler_3d")}
                for name, fn in library.items()}
    wrappers = {
        "warp": lambda: warp(v, v),
        "vecint_inference": lambda: vecint(v, NSTEPS),
        "launch_chain_fwd": lambda: launch_chain_fwd(v),
        "launch_chain_bwd": lambda: launch_chain_bwd(steps, g)}
    emit({"phase": "host_path", "path": "3d",
          "case": f"{shape} VecInt self-warp and chain",
          "launchers": rows, "library": lib_rows,
          "wrappers_us": {k: host_us(fn, calls=200, warmup=20)
                          for k, fn in wrappers.items()}})
    return {"launchers": rows, "library": lib_rows}


CHAIN_CASES = [
    # name, (B, 2, H, W), field kind, velocity scale (px), steps
    ("register", (1, 2, 128, 128), "smooth", 10.0, NSTEPS),  # register's
    ("train", (2, 2, 128, 128), "smooth", 10.0, NSTEPS),     # a step's pos/neg
    ("train_b8", (16, 2, 128, 128), "smooth", 10.0, NSTEPS),
    # the backward's state and sums in global memory (no block of 16 holds
    # its pixels' G in registers or their sums in shared memory)
    ("large", (1, 2, 192, 192), "smooth", 10.0, NSTEPS),
    # the forward's field in global memory (two buffers of a band exceed
    # a block's share of shared memory)
    ("large_fwd", (1, 2, 512, 512), "smooth", 10.0, NSTEPS),
    ("odd_shape", (3, 2, 67, 45), "smooth", 5.0, NSTEPS),
    ("violent", (1, 2, 128, 128), "noise", 25.0, NSTEPS),    # x25 N(0, 1)
    # augment's SVF fields (ops/augment.py: max(s // 8, 2) an axis, N(0,
    # 1), 5 steps): a 64^2 crop's (half the cluster's bands empty), the
    # least (14 of 16 empty), a 200^2 image's (a short last band), 256^2's
    ("aug_crop64", (8, 2, 8, 8), "noise", 1.0, 5),
    ("aug_least", (8, 2, 2, 2), "noise", 1.0, 5),
    ("aug_200", (1, 2, 25, 25), "noise", 1.0, 5),
    ("aug_256", (8, 2, 32, 32), "noise", 1.0, 5),
]
MAIN_CHAIN_CASE = "train"
CHAIN3D_CASES = [
    # name, (B, 3, D, H, W), field kind, velocity scale (voxels; for
    # "edge", max|v_0| exactly), steps
    ("register", (1, 3, 80, 80, 80), "smooth", 10.0, NSTEPS),  # a 3-D register
    ("mild", (1, 3, 80, 80, 80), "smooth", 2.0, NSTEPS),       # call or step
    ("bidir", (2, 3, 80, 80, 80), "posneg", 10.0, NSTEPS),
    ("halo_at_1", (1, 3, 40, 40, 40), "edge", 1.0, 2),   # displacements at
    ("halo_at_2", (1, 3, 40, 40, 40), "edge", 2.0, 2),   # the halo staged
    ("halo_past_2", (1, 3, 40, 40, 40), "edge", 3.0, 2),  # and past it
    ("odd_shape", (2, 3, 17, 33, 45), "smooth", 5.0, NSTEPS),
    ("violent", (1, 3, 40, 40, 40), "noise", 25.0, NSTEPS),    # x25 N(0, 1)
    ("collapse", (1, 3, 80, 80, 80), "collapse", 4.0, NSTEPS),  # crowded
    ("steps_0", (1, 3, 24, 28, 32), "smooth", 5.0, 0),
    ("steps_1", (1, 3, 24, 28, 32), "smooth", 5.0, 1),
    ("steps_2", (1, 3, 24, 28, 32), "smooth", 5.0, 2),
    # the 3-D joint model's chains at 128^3 (int_downsize 2): a register
    # call's and a step's pos / neg
    ("joint_register", (1, 3, 64, 64, 64), "smooth", 10.0, NSTEPS),
    ("joint_train", (2, 3, 64, 64, 64), "posneg", 10.0, NSTEPS),
    # augment's SVF fields, smaller than a brick: 160^3's and the least
    ("aug_160", (1, 3, 20, 20, 20), "noise", 1.0, 5),
    ("aug_least", (2, 3, 2, 2, 2), "noise", 1.0, 5),
]
MAIN_CHAIN3D_CASE = "register"   # the chain of a 3-D register call and step
# flops a pixel (2-D) or voxel (3-D) a step: the forward's coordinates, its
# corner sums for nd channels and the add; the backward's coordinates, its
# dflow and dsrc terms for nd channels and the add of G
CHAIN_FLOPS = {(2, True): 12 + 7 * 2 + 2, (2, False): 12 + 24 * 2 + 4,
               (3, True): 18 + 32 * 3 + 3, (3, False): 41 + (80 + 32) * 3 + 3}


def chain_bytes(B, nd, N, n):
    """The bytes a chain must move over B*N pixels or voxels of nd
    channels: its input (vec, or g and the n saved fields) read once, each
    field it writes (the saved steps and the result, or dvec) once."""
    return 4 * nd * B * N * (1 + n + 1)


def chain_bound(fwd, B, nd, N, n):
    """Least time for a chain's work: the larger of chain_bytes over HBM's
    rate and CHAIN_FLOPS over the float32 peak."""
    return bound(chain_bytes(B, nd, N, n), n * CHAIN_FLOPS[nd, fwd] * B * N)


def launch_chain_fwd(vec, n=NSTEPS):
    """The chain as n direct single-warp launches (B1 at 2-D, B3 at 3-D),
    each with its add: the path before the chain kernels, without
    autograd."""
    single = warp_cuda.warp2d_cuda if vec.ndim == 4 else warp_cuda.warp3d_cuda
    v = vec * (1.0 / 2 ** n)
    for _ in range(n):
        v = v + single(v, v)
    return v


def launch_chain_bwd(steps, g):
    """Its backward as direct launches (B2 at 2-D; B4 and B5 at 3-D), each
    step with the two adds that autograd made."""
    n = steps.shape[0]
    for k in range(n - 1, -1, -1):
        if g.ndim == 4:
            dsrc, dflow = warp_cuda.warp2d_bwd_cuda(steps[k], steps[k], g)
        else:
            dflow = warp_cuda.warp3d_bwd_dflow_cuda(steps[k], steps[k], g)
            dsrc = warp_cuda.warp3d_bwd_dsrc_cuda(steps[k], g)
        g = g + dsrc + dflow
    return g * (1.0 / 2 ** n)


def grid_sample_chain(vec, n=NSTEPS):
    """The chain written with F.grid_sample, its grid rebuilt each step."""
    grid = normalised_grid if vec.ndim == 4 else grid3d
    v = vec * (1.0 / 2 ** n)
    for _ in range(n):
        v = v + F.grid_sample(v, grid(v), mode="bilinear",
                              padding_mode="zeros", align_corners=True)
    return v


def collapse_field(shape, scale, device):
    """(B, nd, *spatial) flow scale * (centre - p): every pixel or voxel
    samples near the centre, so thousands of targets share a few cells."""
    B, nd, *spatial = shape
    grid = identity_grid(spatial, device=device)
    centre = torch.tensor([(n - 1) / 2 for n in spatial],
                          device=device).reshape(nd, *[1] * nd)
    return (scale * (centre - grid))[None].expand(
        B, *[-1] * (nd + 1)).contiguous()


def chain_field(shape, kind, scale, gen, dev, nsteps=NSTEPS):
    """A velocity field: smooth, a smooth half and its negation stacked on
    the batch (posneg, as the bidirectional model integrates them), N(0, 1)
    noise, about +-scale, a collapse (scale * (centre - p)), or a smooth
    field whose first step moves a voxel by exactly scale at most (edge:
    max|vec * 2^-nsteps| is scale)."""
    if kind == "collapse":
        return collapse_field(shape, scale, dev)
    if kind == "edge":
        v = chain_field(shape, "smooth", 1.0, gen, dev)
        return v / v.abs().max() * (scale * 2 ** nsteps)
    if kind == "noise":
        return torch.randn(shape, generator=gen, device=dev) * scale
    smooth = smooth_field if len(shape) == 4 else smooth_field3d
    if kind == "posneg":
        half = smooth((shape[0] // 2, *shape[1:]), scale, gen, dev)
        return torch.cat([half, -half])
    return smooth(shape, scale, gen, dev)


def steps_fit(call_of_n, name):
    """The kernel ``name``'s device us a launch at nsteps = 1..NSTEPS
    (``call_of_n(n)`` returns the call) and the least-squares line through
    them: its slope, the cost of one step, and its intercept, the fixed
    cost of a launch."""
    us = {n: device_us(call_of_n(n), name) for n in range(1, NSTEPS + 1)}
    pts = [(n, t) for n, t in us.items() if t is not None]
    if len(pts) < 2:
        return {"us_by_nsteps": us, "per_step_us": None, "fixed_us": None}
    mn = statistics.fmean(n for n, _ in pts)
    mt = statistics.fmean(t for _, t in pts)
    slope = (sum((n - mn) * (t - mt) for n, t in pts)
             / sum((n - mn) ** 2 for n, _ in pts))
    return {"us_by_nsteps": us, "per_step_us": slope,
            "fixed_us": mt - slope * mn}


def chain_steps_fit(kernel, vec, g):
    """``steps_fit`` of a chain kernel on vec (its cotangent g): the
    forward saving its steps and not, or the backward of the forward's
    saved steps."""
    if kernel in (VF, VF3):
        fwd = (warp_cuda.vecint2d_fwd_cuda if kernel == VF
               else warp_cuda.vecint3d_fwd_cuda)
        return {"save": steps_fit(lambda n: lambda: fwd(vec, n, save=True),
                                  kernel),
                "inference": steps_fit(
                    lambda n: lambda: fwd(vec, n, save=False), kernel)}
    fwd, bwd = ((warp_cuda.vecint2d_fwd_cuda, warp_cuda.vecint2d_bwd_cuda)
                if kernel == VB else
                (warp_cuda.vecint3d_fwd_cuda, warp_cuda.vecint3d_bwd_cuda))

    def call_of_n(n):
        steps = fwd(vec, n, save=True)[1]
        return lambda: bwd(steps, g)

    return {"save": steps_fit(call_of_n, kernel)}


def yard_sync_call(entry, *args):
    d = torch.cuda.current_device()
    fn = _yard[entry]

    def call():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(d))
        if err:
            raise RuntimeError(f"yardstick {entry}{args}: cudaError {err}")

    return call


def barrier_us(entry, *args, n=1000):
    """One barrier's device us from the csrc/yardsticks/sync.cu launch that
    does nothing but barriers: the launch with ``n`` of them less the one
    with none (CUDA events, median of 20), over ``n``."""
    with_n = time_ms(yard_sync_call(entry, *args, n), reps=20, warmup=3)
    none = time_ms(yard_sync_call(entry, *args, 0), reps=20, warmup=3)
    return (with_n - none) * 1e3 / n


STEP_CASES = [
    # kernel, case, (B, nd, *spatial), field kind, velocity scale
    (VF, "register", (1, 2, 128, 128), "smooth", 10.0),
    (VF, "train", (2, 2, 128, 128), "smooth", 10.0),
    (VF, "train_b8", (16, 2, 128, 128), "smooth", 10.0),
    (VF, "large_fwd", (1, 2, 512, 512), "smooth", 10.0),
    (VB, "train", (2, 2, 128, 128), "smooth", 10.0),
    (VB, "train_b8", (16, 2, 128, 128), "smooth", 10.0),
    (VF3, "register", (1, 3, 80, 80, 80), "smooth", 10.0),
    (VF3, "mild", (1, 3, 80, 80, 80), "smooth", 2.0),
]
# B2's cases timed by --steps, both gradients
STEP_BWD_CASES = ("registered", "vecint_step", "collapse")


def phase_chain_steps(seed):
    """Where the chains' time goes: each at nsteps = 1..7
    (``chain_steps_fit``) at STEP_CASES; B2 with both gradients at
    STEP_BWD_CASES, device us a launch and ms beside
    grid_sampler_2d_backward's; and one barrier alone: a grid.sync() over
    1, 2, 4 and 5 blocks of 256 threads a SM, and a cluster barrier over
    clusters of 8 and 16 blocks.  It calls the wrappers alone, so it runs
    against an earlier tree's library too."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    rows = {}
    for kernel, name, shape, kind, scale in STEP_CASES:
        vec = chain_field(shape, kind, scale, gen, dev)
        g = torch.randn(shape, generator=gen, device=dev)
        rows[kernel, name] = chain_steps_fit(kernel, vec, g)
        emit({"phase": "chain_steps", "kernel": kernel, "case": name,
              "shape": list(shape), "vec_px": scale, **rows[kernel, name]})
    for (name, shape, kind, scale, shift, need_dsrc,
         alias) in BWD_CASES:
        if name not in STEP_BWD_CASES:
            continue
        src, flow, g = bwd_case_inputs(shape, kind, scale, shift, alias,
                                       gen, dev)
        kernel = lambda: warp_cuda.warp2d_bwd_cuda(  # noqa: E731
            src, flow, g, need_dsrc)
        library, _ = grid_sample_bwd_call(src, flow, g, need_dsrc)
        rows[BWD, name] = {
            "device_us_per_launch": device_us(kernel, BWD),
            "ms": time_ms(kernel),
            "library_device_us_per_call": device_us(library),
            "library_ms": time_ms(library),
            "bound_ms": warp2d_bwd_bound(*shape, need_dsrc, alias)[0]}
        emit({"phase": "chain_steps", "kernel": BWD, "case": name,
              "shape": list(shape), **rows[BWD, name]})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = {f"{k}_per_sm": barrier_us("dfmir_yard_grid_sync", k * sms)
            for k in (1, 2, 4, 5)}
    cluster = {f"{c}x{s}": barrier_us("dfmir_yard_cluster_sync", c, s)
               for c, s in ((2, 8), (16, 8), (2, 16), (16, 16))}
    emit({"phase": "chain_steps", "grid_sync_us": grid,
          "cluster_sync_us": cluster, "sms": sms})
    return rows


def halo_report(steps, dims):
    """The 3-D forward chain's halos and the corners it reads from L2, from
    the fields v_0..v_{n-1} it stepped (``steps``) and its brick geometry
    ``dims`` (brick z, y, x, most halo, x pad; warp_cuda.brick3d): each
    brick's halo a step is min(ceil(max|v_k| over its voxels), the most),
    its box that halo around the brick in z and y and the x pad in x; a
    corner inside the volume but outside its voxel's box is read from L2.
    Returns each step's bricks at each halo and share of corners from
    L2."""
    *brick, most, pad = dims
    bricks_by_halo, shares = [], []
    inside = outside = 0
    for v in steps:
        spatial = v.shape[2:]
        nb = [-(-n // b) for n, b in zip(spatial, brick)]
        mag = v.abs().amax(dim=1, keepdim=True)
        mag = F.pad(mag, [0, nb[2] * brick[2] - spatial[2],
                          0, nb[1] * brick[1] - spatial[1],
                          0, nb[0] * brick[0] - spatial[0]])
        m = F.max_pool3d(mag, brick, brick)[:, 0]         # (B, *nb)
        h = torch.where(m.isfinite(), m.ceil().clamp(max=most),
                        torch.full_like(m, most))
        bricks_by_halo.append([int((h == k).sum()) for k in range(most + 1)])
        for a, b in enumerate(brick):
            h = h.repeat_interleave(b, dim=a + 1)
        h = h[:, :spatial[0], :spatial[1], :spatial[2]]   # (B, D, H, W)
        grid = identity_grid(spatial, device=v.device)
        z0 = [(grid[a] + v[:, a]).clamp(-2.0, n + 1.0).floor()
              for a, n in enumerate(spatial)]
        lo = [(grid[a] // b) * b - h for a, b in enumerate(brick[:2])]
        lo.append((grid[2] // brick[2]) * brick[2] - pad + 0 * h)
        size = [brick[0] + 2 * h + 1, brick[1] + 2 * h + 1,
                brick[2] + 2 * pad + 0 * h]
        n_in = n_out = 0
        for k in range(8):
            d = (k >> 2, (k >> 1) & 1, k & 1)
            vol = box = True
            for a in range(3):
                c = z0[a] + d[a]
                vol = vol & (c >= 0) & (c < spatial[a])
                box = box & (c >= lo[a]) & (c - lo[a] < size[a])
            n_in += int(vol.sum())
            n_out += int((vol & ~box).sum())
        shares.append(n_out / max(n_in, 1))
        inside += n_in
        outside += n_out
    return {"bricks_by_halo_by_step": bricks_by_halo,
            "l2_corner_share_by_step": shares,
            "l2_corner_share": outside / max(inside, 1)}


def launch_vecint2d_bwd(steps, g, cluster):
    """vecint2d_bwd_cuda with clusters of ``cluster`` blocks (the wrapper
    takes the kernel's own size); the launch is counted as the wrapper's."""
    dvec = torch.empty_like(g)
    sums = torch.empty(g.shape, dtype=torch.int64, device=g.device)
    warp_cuda._launch(VB, "dfmir_vecint2d_bwd", g.get_device(),
                      steps.data_ptr(), g.data_ptr(), sums.data_ptr(),
                      dvec.data_ptr(), g.shape[0], *g.shape[2:],
                      steps.shape[0], cluster)
    return dvec


def launch_vecint2d_fwd(vec, n, cluster):
    """vecint2d_fwd_cuda(vec, n, save=True)'s output with clusters of
    ``cluster`` blocks; the launch is counted as the wrapper's."""
    out = torch.empty_like(vec)
    steps = vec.new_empty((n, *vec.shape))
    warp_cuda._launch(VF, "dfmir_vecint2d_fwd", vec.get_device(),
                      vec.data_ptr(), steps.data_ptr(), out.data_ptr(),
                      vec.shape[0], *vec.shape[2:], n, 1, cluster)
    return out


def vecint2d_bwd_clusters(size=0):
    """(blocks a cluster, clusters the card holds at once) of vecint2d_bwd
    at ``size`` blocks a cluster, 0 for the kernel's own."""
    size, active = ctypes.c_int(size), ctypes.c_int(0)
    err = _build.load().dfmir_vecint2d_bwd_clusters(ctypes.byref(size),
                                                    ctypes.byref(active))
    if err:
        raise RuntimeError(f"cluster occupancy query: cudaError {err}")
    return size.value, active.value


def cluster_report(kernel, call_of_size, result):
    """The 2-D chain kernel ``kernel`` at clusters of 8 and 16 blocks
    (``call_of_size(size)`` returns the call): each bit-equal to the
    wrapper's ``result``, its ms and device us; for vecint2d_bwd the
    clusters the card holds at once."""
    rows = {}
    for size in (8, 16):
        call = call_of_size(size)
        rows[size] = {"equal": torch.equal(call(), result),
                      "ms": time_ms(call),
                      "device_us": device_us(call, kernel)}
        if kernel == VB:
            rows[size]["active_clusters"] = vecint2d_bwd_clusters(size)[1]
        if not rows[size]["equal"]:
            raise AssertionError(f"{kernel} with clusters of {size} blocks "
                                 f"disagrees with the wrapper's result")
    return rows


def run_chains(phase, cases, names, seed, profile):
    """Each case through the chain kernels ``names`` (forward, backward)
    against the plain loop (forward bit-equal, saving its steps and not;
    backward within 1e-5 * max(1, max|dvec|) and bitwise the same over two
    calls; the 2-D backward bit-equal to vecint2d_bwd_fixed_plain), timed
    beside their bound, the plain loop, the same chain as direct
    single-warp launches with their adds and the F.grid_sample chain.  At
    the main cases (and the 3-D "mild"): device us, each kernel's cost a
    step and fixed cost (nsteps 1..7), the 3-D forward's halo a step and
    share of corners read from L2, the 2-D backward at clusters of 8 and
    16 blocks."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kf, kb = names
    fwd_cuda, bwd_cuda = ((warp_cuda.vecint2d_fwd_cuda,
                           warp_cuda.vecint2d_bwd_cuda) if kf == VF else
                          (warp_cuda.vecint3d_fwd_cuda,
                           warp_cuda.vecint3d_bwd_cuda))
    rows = {kf: {}, kb: {}}
    for name, shape, kind, scale, n in cases:
        B, nd, *spatial = shape
        N = math.prod(spatial)
        vec = chain_field(shape, kind, scale, gen, dev, n)
        g = torch.randn(shape, generator=gen, device=dev)
        out, steps = fwd_cuda(vec, n, save=True)
        out_inf, _ = fwd_cuda(vec, n, save=False)
        dvec = bwd_cuda(steps, g)
        # both backwards sum their source gradients in a fixed point
        same = torch.equal(dvec, bwd_cuda(steps, g))
        fixed_err = (float((dvec - integrate.vecint2d_bwd_fixed_plain(
            steps, g)).abs().max()) if kb == VB else None)
        torch.cuda.synchronize()
        ref = vecint(vec, n, impl="torch")
        ref_dvec = vecint_bwd_plain(vec, n, g)
        err = max(float((out - ref).abs().max()),
                  float((out_inf - ref).abs().max()))
        err_bwd = float((dvec - ref_dvec).abs().max())
        tol_bwd = KERNEL_TOL * max(1.0, float(ref_dvec.abs().max()))
        moved = float((ref - vec / 2 ** n).abs().max())
        if n == NSTEPS and kind != "noise" and not moved > 1.0:
            raise AssertionError(f"{name}: the integrated field moved "
                                 f"{moved} px from vec * 2^-n: the chain "
                                 f"tests nothing across blocks")
        v = vec.clone().requires_grad_()
        gs_out = grid_sample_chain(v, n)
        gs_bwd = lambda: torch.autograd.grad(  # noqa: E731
            gs_out, v, g, retain_graph=True)
        calls = {
            kf: {"kernel": lambda: fwd_cuda(vec, n, save=True),
                 "plain": lambda: vecint(vec, n, impl="torch"),
                 "launches": lambda: launch_chain_fwd(vec, n),
                 "grid_sample": lambda: grid_sample_chain(vec, n)},
            kb: {"kernel": lambda: bwd_cuda(steps, g),
                 "plain": lambda: vecint_bwd_plain(vec, n, g),
                 "launches": lambda: launch_chain_bwd(steps, g),
                 "grid_sample": gs_bwd}}
        before_err = {
            kf: float((launch_chain_fwd(vec, n) - ref).abs().max()),
            kb: float((launch_chain_bwd(steps, g) - ref_dvec).abs().max())}
        gs_err = {kf: float((gs_out - ref).abs().max()),
                  kb: float((gs_bwd()[0] - ref_dvec).abs().max())}
        main = (name == MAIN_CHAIN_CASE if nd == 2
                else name in (MAIN_CHAIN3D_CASE, "mild"))
        for k in (kf, kb):
            c = calls[k]
            bound_ms, bound_by = chain_bound(k == kf, B, nd, N, n)
            row = {"case": name, "shape": list(shape), "field": kind,
                   "vec_px": scale, "nsteps": n,
                   "max_abs_err": err if k == kf else err_bwd,
                   "tol": 0.0 if k == kf else tol_bwd,
                   "ms": time_ms(c["kernel"]),
                   "plain_ms": time_ms(c["plain"], reps=5, warmup=1),
                   "launch_chain_ms": time_ms(c["launches"]),
                   "launch_chain_max_abs_err": before_err[k],
                   "grid_sample_chain_ms": time_ms(c["grid_sample"],
                                                   reps=20, warmup=2),
                   "grid_sample_chain_max_abs_err": gs_err[k],
                   "library_ms": None,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes_bound_ms": chain_bytes(B, nd, N, n)
                   / HBM_BYTES_PER_S * 1e3}
            if k == kb:
                row["bit_reproducible"] = same
                if fixed_err is not None:
                    row["fixed_max_abs_err"] = fixed_err
            if k == kf:
                row["ms_inference"] = time_ms(
                    lambda: fwd_cuda(vec, n, save=False))
                row["inference_bound_ms"], row["inference_bound_by"] = bound(
                    chain_bytes(B, nd, N, 0),
                    n * CHAIN_FLOPS[nd, True] * B * N)
                row["field_max_px"] = float(ref.abs().max())
                row["moved_px"] = moved
                if nd == 3:
                    row.update(halo_report(steps, warp_cuda.brick3d()))
            if profile or main:
                row["device_us_per_launch"] = device_us(c["kernel"], k)
                if k == kf:
                    row["device_us_inference"] = device_us(
                        lambda: fwd_cuda(vec, n, save=False), k)
                row["launch_chain_device_us"] = device_us(c["launches"])
                row["grid_sample_chain_device_us"] = device_us(
                    c["grid_sample"])
            if main and n == NSTEPS:
                fit = chain_steps_fit(k, vec, g)
                row["per_step_us"] = fit["save"]["per_step_us"]
                row["fixed_us"] = fit["save"]["fixed_us"]
                row["steps_fit"] = fit
            if main and k == VB:
                row["blocks_per_cluster"] = vecint2d_bwd_clusters()[0]
                row["clusters"] = cluster_report(
                    VB, lambda size: lambda: launch_vecint2d_bwd(
                        steps, g, size), dvec)
            if main and k == VF:
                row["clusters"] = cluster_report(
                    VF, lambda size: lambda: launch_vecint2d_fwd(
                        vec, n, size), out)
            emit({"phase": phase, "kernel": k, **row})
            if not row["max_abs_err"] <= row["tol"]:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on {name}: {row['max_abs_err']} > "
                                     f"{row['tol']}")
            if row.get("bit_reproducible") is False:
                raise AssertionError(f"{k} gave two results on {name}")
            if row.get("fixed_max_abs_err", 0.0) != 0.0:
                raise AssertionError(f"{k} differs from its fixed-point "
                                     f"model on {name}: "
                                     f"{row['fixed_max_abs_err']}")
            rows[k][name] = row
        del steps, gs_out, v
    return rows


def phase_kernel_chain(seed, profile):
    """VecInt's 2-D chain kernels against the plain loop (run_chains)."""
    return run_chains("kernel", CHAIN_CASES, (VF, VB), seed + 12, profile)


def phase_kernel_chain3d(seed, profile):
    """VecInt's 3-D chain kernels against the plain loop (run_chains),
    device times at the main case always."""
    return run_chains("kernel_chain3d", CHAIN3D_CASES, (VF3, VB3), seed + 13,
                      profile)


# ------------------------------------------------------------ phase 4
def make_pairs(n, batch, size, seed, device):
    gen = torch.Generator().manual_seed(seed)
    pairs = []
    for _ in range(n):
        a = torch.tanh(smooth_field((batch, 1, size, size), 1.5, gen, "cpu")
                       + 0.1 * torch.randn((batch, 1, size, size),
                                           generator=gen))
        b = torch.tanh(smooth_field((batch, 1, size, size), 1.5, gen, "cpu"))
        regions = smooth_field((batch, 1, size, size), 1.0, gen, "cpu")
        label = torch.bucketize(regions, torch.tensor([-0.5, 0.0, 0.5]))
        label = label.float() * 60 / 255          # test.py's uint8 / 255
        pairs.append(tuple(t.to(device) for t in (a, b, label)))
    return pairs


def build_model(cfg, seed, device, gain=FLOW_GAIN):
    model = RegistrationModel(cfg, device=device,
                              generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.netR.flow.weight.mul_(gain)
    return model


def phase_register(seed, smi):
    cfg = RegistrationConfig()
    S = cfg.crop_size
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(N_PAIRS, 1, S, seed, DEVICE)

    # the main path, counted
    warp_cuda.reset_launches()
    outs = [infer.register_pair_outputs(model, a, b, label=lab)
            for a, b, lab in pairs]
    torch.cuda.synchronize()
    launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * N_PAIRS for k, v in REGISTER_LAUNCHES.items()}
    if launches != dict(ZERO, **want):
        raise AssertionError(f"{launches} kernel launches over {N_PAIRS} "
                             f"register calls, expected {want}")
    shapes = {"fake_B": (1, 1, S, S), "idt_B": (1, 1, S, S),
              "y_source": (1, 1, S, S), "pos_flow": (1, 2, S, S),
              "jac_det": (1, S, S), "folding_fraction": (1,),
              "label_warped": (1, 1, S, S)}
    for o in outs:
        for k, shape in shapes.items():
            if tuple(o[k].shape) != shape or not bool(o[k].isfinite().all()):
                raise AssertionError(f"{k}: shape {tuple(o[k].shape)} "
                                     f"(expected {shape}) or not finite")
    flow_max = max(float(o["pos_flow"].abs().max()) for o in outs)
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} px: the field does "
                             f"not deform, the warps test nothing")

    # the same weights on the CPU (plain warp), one pair
    cpu = build_model(cfg, seed, "cpu")
    a, b, lab = (t.cpu() for t in pairs[0])
    t0 = time.perf_counter()
    ref = infer.register_pair_outputs(cpu, a, b, label=lab)
    cpu_s = time.perf_counter() - t0
    errs = {k: float((outs[0][k].cpu() - ref[k]).abs().max())
            for k in ("fake_B", "idt_B", "y_source", "pos_flow", "jac_det")}
    label_mismatch = float((outs[0]["label_warped"].cpu()
                            != ref["label_warped"]).float().mean())
    for k in ("fake_B", "y_source", "pos_flow"):
        if not errs[k] <= PATH_TOL:
            raise AssertionError(f"{k}: card vs CPU {errs[k]} > {PATH_TOL}")

    a, b, lab = pairs[0]
    ms_b1 = time_ms(lambda: infer.register_pair_outputs(model, a, b, lab),
                    reps=10, warmup=2)
    (a8, b8, lab8), = make_pairs(1, 8, S, seed + 1, DEVICE)
    ms_b8 = time_ms(lambda: infer.register_pair_outputs(model, a8, b8, lab8),
                    reps=10, warmup=2)
    emit({"phase": "register", "config": "RegistrationConfig() defaults",
          "crop": S, "ngf": cfg.ngf, "netG": cfg.netG,
          "vxm": [list(cfg.vxm_enc), list(cfg.vxm_dec)],
          "pairs": N_PAIRS, "launches": launches,
          "launches_per_register": {k: v / N_PAIRS
                                    for k, v in launches.items() if v},
          "pos_flow_max_px": flow_max,
          "folding_fraction": [float(o["folding_fraction"][0]) for o in outs],
          "card_vs_cpu_max_abs": errs, "label_mismatch_fraction":
          label_mismatch, "cpu_pair_s": cpu_s,
          "ms_per_pair_b1": ms_b1, "pairs_per_s_b8": 8e3 / ms_b8,
          "ms_per_call_b8": ms_b8, "card": smi})
    return model, launches, ms_b1


# ------------------------------------------------------------ phase 5
SMALL = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
             vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
             netF_nc=16, num_patches=16)
NETS = ("netG", "netF", "netR")


def patch_gen(seed):
    """A CPU generator for the patch ids: one seed, the same ids on the
    card and on the CPU."""
    return torch.Generator().manual_seed(seed)


def rel_errs(card, cpu, tol, what, tols=None):
    """Relative difference of each metric; raises past ``tol`` (past
    ``tols[k]`` for a metric k that ``tols`` names)."""
    errs = {k: abs(card[k] - v) / max(abs(v), 1e-12) for k, v in cpu.items()}
    bad = {k: e for k, e in errs.items()
           if not e <= (tols or {}).get(k, tol)}
    if bad:
        raise AssertionError(f"{what}: card vs CPU metrics differ by {bad} "
                             f"(relative) > {tol} ({tols or {}})")
    return errs


def loss_and_grads(model, a, b, seed):
    """One loss_fn and backward; (metrics, {net: [grad, ...]}) on the CPU
    in float64."""
    model.optimizer.zero_grad(set_to_none=True)
    total, metrics, _ = model.loss_fn(a, b, generator=patch_gen(seed))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {net: [p.grad.detach().cpu().double() for p in
                   getattr(model, net).parameters()] for net in NETS})


def small_step_vs_cpu(seed):
    """A reduced-width loss and backward (the CPU tests' config) on the card
    against the CPU: metrics 1e-3 relative; gradients within GRAD_ENV *
    max|g| of the CPU in float32 and GRAD_ENV_F64 * max|g| of the CPU in
    float64; a train step's launches (STEP_LAUNCHES) on the card."""
    cfg = RegistrationConfig(**SMALL)
    gen = torch.Generator().manual_seed(seed + 3)
    a, b = (torch.tanh(2 * torch.randn((2, 1, 64, 64), generator=gen))
            for _ in range(2))
    out = {}
    for run, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        model = build_model(cfg, seed, dev)
        for net in NETS:
            getattr(model, net).to(dtype)
        warp_cuda.reset_launches()
        out[run] = loss_and_grads(model, a.to(dev, dtype), b.to(dev, dtype),
                                  seed)
        if run == "card":
            torch.cuda.synchronize()
            launches = dict(warp_cuda.LAUNCHES)
            if launches != dict(ZERO, **STEP_LAUNCHES):
                raise AssertionError(f"small step: {launches} launches, "
                                     f"expected {STEP_LAUNCHES}")
    metric_errs = rel_errs(out["card"][0], out["cpu"][0], PATH_TOL,
                           "small step")
    grad_errs = {}
    for net in NETS:
        exact = out["cpu_f64"][1][net]
        scale = max(float(g.abs().max()) for g in exact)

        def rel(run):
            return max(float((x - y).abs().max())
                       for x, y in zip(out[run][1][net], exact)) / scale

        card_cpu = max(float((x - y).abs().max()) for x, y in
                       zip(out["card"][1][net], out["cpu"][1][net])) / scale
        grad_errs[net] = {"net_scale": scale, "card_vs_cpu": card_cpu,
                          "card_vs_f64": rel("card"),
                          "cpu_vs_f64": rel("cpu")}
        if not (card_cpu <= GRAD_ENV and rel("card") <= GRAD_ENV_F64):
            raise AssertionError(f"small step {net}: card gradients off by "
                                 f"{grad_errs[net]} (relative to max |g|): "
                                 f"bars {GRAD_ENV} (CPU), {GRAD_ENV_F64} "
                                 f"(float64)")
    return metric_errs, grad_errs


def time_steps(model, pairs, lr, seed):
    """train_step over ``pairs``; host ms of each (ending in a
    synchronize) and its metrics as floats."""
    gen = patch_gen(seed)
    ms, history = [], []
    for a, b, _ in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = model.train_step(a, b, lr, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    return ms, history


def phase_train(seed, smi):
    cfg = RegistrationConfig()
    S = cfg.crop_size
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(1 + TRAIN_STEPS, 1, S, seed + 2, DEVICE)

    # full width: one loss_fn on the card and on the CPU, same weights and
    # patch ids, before any step
    a, b, _ = pairs[0]
    cpu = build_model(cfg, seed, "cpu")
    with torch.no_grad():
        _, m_card, aux = model.loss_fn(a, b, generator=patch_gen(seed))
        t0 = time.perf_counter()
        _, m_cpu, _ = cpu.loss_fn(a.cpu(), b.cpu(), generator=patch_gen(seed))
        cpu_s = time.perf_counter() - t0
    del cpu
    flow_max = float(aux["pos_flow"].abs().max())
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} px: the field does "
                             f"not deform, the warps test nothing")
    full_errs = rel_errs({k: float(v) for k, v in m_card.items()},
                         {k: float(v) for k, v in m_cpu.items()}, PATH_TOL,
                         "full-width loss_fn")

    # the main path, counted: 1 warm-up + TRAIN_STEPS timed steps
    before = {(net, name): p.detach().clone() for net in NETS
              for name, p in getattr(model, net).named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    step_ms, history = time_steps(model, pairs, cfg.lr, seed)
    launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * len(pairs) for k, v in STEP_LAUNCHES.items()}
    if launches != dict(ZERO, **want):
        raise AssertionError(f"{launches} kernel launches over "
                             f"{len(pairs)} train steps, expected {want}")
    peak_b1 = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not v == v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite metrics (step, name): {bad}")
    unmoved = [f"{net}.{name}" for net in NETS
               for name, p in getattr(model, net).named_parameters()
               if torch.equal(p.detach(), before[(net, name)])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} parameters did not move: "
                             f"{unmoved[:8]}")
    del before

    small_metric_errs, small_grad_errs = small_step_vs_cpu(seed)

    pairs8 = make_pairs(4, 8, S, seed + 4, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ms8, _ = time_steps(model, pairs8, cfg.lr, seed)
    peak_b8 = torch.cuda.max_memory_allocated()
    ms_b1 = statistics.median(step_ms[1:])
    ms_b8 = statistics.median(ms8[1:])
    emit({"phase": "train", "config": "RegistrationConfig() defaults",
          "crop": S, "ngf": cfg.ngf, "netG": cfg.netG, "netF": cfg.netF,
          "num_patches": cfg.num_patches, "nce_layers": list(cfg.nce_layers),
          "vxm": [list(cfg.vxm_enc), list(cfg.vxm_dec)],
          "steps": len(pairs), "launches": launches,
          "launches_per_step": {k: v / len(pairs)
                                for k, v in launches.items() if v},
          "pos_flow_max_px": flow_max,
          "full_width_card_vs_cpu_rel": full_errs, "cpu_loss_fn_s": cpu_s,
          "small_step_card_vs_cpu_rel": small_metric_errs,
          "small_step_grad_card_vs_cpu": small_grad_errs,
          "metrics_first": history[0], "metrics_last": history[-1],
          "step_ms_b1": step_ms, "ms_per_step_b1": ms_b1,
          "train_pairs_per_s_b1": 1e3 / ms_b1,
          "step_ms_b8": ms8, "ms_per_step_b8": ms_b8,
          "train_pairs_per_s_b8": 8e3 / ms_b8,
          "peak_mem_gb_b1": peak_b1 / 1e9, "peak_mem_gb_b8": peak_b8 / 1e9,
          "card": smi})
    return model, launches, ms_b1


# ------------------------------------------------- the training options
# the paper model's training options, each at RegistrationConfig()'s full
# width (WIDTH: fields beside the defaults; empty on the card)
WIDTH = {}
FASTCUT = dict(flip_equivariance=True, nce_idt=False, lambda_NCE=10.0)
GAN = dict(lambda_GAN=1.0, netD="basic", gan_mode="lsgan")
BF16 = dict(compute_dtype="bfloat16")
DROPOUT = dict(no_dropout=False)
# bf16: a field below 0.25 px (about 0.1 at full width), where one bf16
# ulp of the flow head's output is under the pos_flow bar; the bars are
# the JAX suite's own bf16 ones (tests/test_perf_paths.py) and
# tests/test_torch_bf16.py's
BF16_GAIN = 4e3
BF16_BARS = {"fake_B": 0.1, "idt_B": 0.1, "y_source": 1e-2,
             "pos_flow": 1e-3}
BF16_METRIC_TOL = 1e-2
KEEP_SIGMAS = 5.0        # dropout keep rate: 0.5 within 5 binomial sigmas


def option_cfg(option):
    return RegistrationConfig(**WIDTH, **option)


def card_cpu_metrics(card, cpu, a, b, seed, tol, what, **kw):
    """One loss_fn (no gradient) on the card and on the CPU, the same
    weights and patch ids: (card metrics, relative differences)."""
    with torch.no_grad():
        _, m_card, aux = card.loss_fn(a, b, generator=patch_gen(seed), **kw)
        _, m_cpu, _ = cpu.loss_fn(a.cpu(), b.cpu(),
                                  generator=patch_gen(seed), **kw)
    card_m = {k: float(v) for k, v in m_card.items()}
    return card_m, rel_errs(card_m, {k: float(v) for k, v in m_cpu.items()},
                            tol, what), aux


def counted_steps(model, pairs, lr, seed, what):
    """1 warm-up + len(pairs) - 1 timed train steps, counted: (ms of each,
    metrics of each, launches, peak bytes).  Every step launches exactly
    STEP_LAUNCHES, and every metric is finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    ms, history = time_steps(model, pairs, lr, seed)
    launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"{what}, {len(pairs)} steps", launches,
                   add_counts((len(pairs), STEP_LAUNCHES)))
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")
    return ms, history, launches, torch.cuda.max_memory_allocated()


def step_summary(ms, history, launches, peak, train_ms):
    return {"steps": len(ms), "launches": launches,
            "launches_per_step": {k: v / len(ms)
                                  for k, v in launches.items() if v},
            "step_ms_b1": ms, "ms_per_step_b1": statistics.median(ms[1:]),
            "f32_cut_ms_per_step_b1": train_ms,
            "peak_mem_gb_b1": peak / 1e9, "metrics_first": history[0],
            "metrics_last": history[-1]}


def phase_fastcut(seed, smi, train_ms):
    """FastCUT (flip equivariance, nce_idt off, lambda_NCE 10): card vs
    CPU loss_fn at each coin, then counted and timed steps."""
    cfg = option_cfg(FASTCUT)
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(1 + TRAIN_STEPS, 1, cfg.crop_size, seed + 5, DEVICE)
    cpu = build_model(cfg, seed, "cpu")
    a, b, _ = pairs[0]
    errs = {}
    for coin in (False, True):
        _, errs[str(coin)], aux = card_cpu_metrics(
            model, cpu, a, b, seed, PATH_TOL, f"fastcut coin {coin}",
            flip=coin)
    del cpu
    ms, history, launches, peak = counted_steps(model, pairs, cfg.lr, seed,
                                                "fastcut")
    emit({"phase": "fastcut", "config": "RegistrationConfig() with "
          "CUT_mode FastCUT's settings", **{k: getattr(cfg, k) for k in
                                            FASTCUT},
          "crop": cfg.crop_size, "ngf": cfg.ngf, "netG": cfg.netG,
          "card_vs_cpu_rel_by_coin": errs,
          "pos_flow_max_px": float(aux["pos_flow"].abs().max()),
          **step_summary(ms, history, launches, peak, train_ms),
          "card": smi})
    return launches, statistics.median(ms[1:])


def phase_gan(seed, smi, train_ms):
    """lambda_GAN 1, netD basic, lsgan: one two-phase step on the card and
    on the CPU from the same weights (metrics, D's among them), netD
    moving, then counted and timed steps."""
    cfg = option_cfg(GAN)
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(1 + TRAIN_STEPS, 1, cfg.crop_size, seed + 6, DEVICE)
    cpu = build_model(cfg, seed, "cpu")
    a, b, _ = pairs[0]
    d_before = [p.detach().clone() for p in model.netD.parameters()]
    m_card = model.train_step(a, b, cfg.lr, generator=patch_gen(seed))
    m_cpu = cpu.train_step(a.cpu(), b.cpu(), cfg.lr,
                           generator=patch_gen(seed))
    del cpu
    card_m = {k: float(v) for k, v in m_card.items()}
    errs = rel_errs(card_m, {k: float(v) for k, v in m_cpu.items()},
                    PATH_TOL, "gan step")
    missing = {"G_GAN", "D", "D_fake", "D_real"} - set(errs)
    unmoved = sum(torch.equal(p.detach(), q) for p, q in
                  zip(model.netD.parameters(), d_before))
    if missing or unmoved:
        raise AssertionError(f"gan step: metrics {sorted(card_m)} lack "
                             f"{missing}, or {unmoved} netD tensors did "
                             f"not move")
    ms, history, launches, peak = counted_steps(model, pairs, cfg.lr, seed,
                                                "gan")
    emit({"phase": "gan", "config": "RegistrationConfig() with lambda_GAN "
          "1", "netD": cfg.netD, "ndf": cfg.ndf, "gan_mode": cfg.gan_mode,
          "crop": cfg.crop_size, "netD_params": sum(
              p.numel() for p in model.netD.parameters()),
          "first_step_card_vs_cpu_rel": errs, "first_step_metrics": card_m,
          "netD_tensors_moved": len(d_before),
          **step_summary(ms, history, launches, peak, train_ms),
          "card": smi})
    return launches, statistics.median(ms[1:])


def phase_bf16(seed, smi, register_ms, train_ms):
    """compute_dtype bfloat16: register (B=1, CUDA events, median of 10)
    and the step (median of 5) beside the float32 ones of phases register
    and train; card vs CPU-bf16 under BF16_BARS; master parameters
    float32; launches exact."""
    cfg = option_cfg(BF16)
    model = build_model(cfg, seed, DEVICE, BF16_GAIN)
    pairs = make_pairs(1 + TRAIN_STEPS, 1, cfg.crop_size, seed + 7, DEVICE)
    a, b, lab = pairs[0]

    # register, counted, then card vs the CPU's bf16
    torch.cuda.synchronize()
    warp_cuda.reset_launches()
    outs = [infer.register_pair_outputs(model, x, y, label=z)
            for x, y, z in pairs[:N_PAIRS]]
    torch.cuda.synchronize()
    reg_launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"bf16 register, {N_PAIRS} calls", reg_launches,
                   add_counts((N_PAIRS, REGISTER_LAUNCHES)))
    cpu = build_model(cfg, seed, "cpu", BF16_GAIN)
    t0 = time.perf_counter()
    ref = infer.register_pair_outputs(cpu, a.cpu(), b.cpu(), label=lab.cpu())
    cpu_s = time.perf_counter() - t0
    reg_errs = {k: float((outs[0][k].cpu() - ref[k]).abs().max())
                for k in BF16_BARS}
    bad = {k: e for k, e in reg_errs.items() if not e <= BF16_BARS[k]}
    dtypes = {k: str(v.dtype) for k, v in outs[0].items()}
    if bad or any(v.dtype == torch.bfloat16 for v in outs[0].values()):
        raise AssertionError(f"bf16 register: card vs CPU {bad} past "
                             f"{BF16_BARS}, or outputs {dtypes}")
    flow_max = max(float(o["pos_flow"].abs().max()) for o in outs)
    _, loss_errs, _ = card_cpu_metrics(model, cpu, a, b, seed,
                                       BF16_METRIC_TOL, "bf16 loss_fn")
    del cpu, ref
    reg_ms = time_ms(lambda: infer.register_pair_outputs(model, a, b, lab),
                     reps=10, warmup=2)

    ms, history, launches, peak = counted_steps(model, pairs, cfg.lr, seed,
                                                "bf16")
    wrong = [n for net in NETS for n, p in getattr(model, net)
             .named_parameters() if p.dtype != torch.float32]
    wrong += [str(i) for i, st in model.optimizer.state.items()
              if st["exp_avg"].dtype != torch.float32]
    if wrong:
        raise AssertionError(f"bf16: master parameters or Adam state not "
                             f"float32: {wrong[:8]}")
    emit({"phase": "bf16", "config": "RegistrationConfig() with "
          "compute_dtype bfloat16", "crop": cfg.crop_size,
          "flow_gain": BF16_GAIN, "pos_flow_max_px": flow_max,
          "register_launches": reg_launches, "bars": BF16_BARS,
          "register_card_vs_cpu_max_abs": reg_errs, "output_dtypes": dtypes,
          "loss_card_vs_cpu_rel": loss_errs, "cpu_register_s": cpu_s,
          "ms_per_pair_b1": reg_ms, "f32_ms_per_pair_b1": register_ms,
          "master_dtype": "float32",
          **step_summary(ms, history, launches, peak, train_ms),
          "card": smi})
    return reg_launches, launches, reg_ms, statistics.median(ms[1:])


def dropout_masks(model, fn):
    """fn() with every Dropout module's mask recorded where its input is
    not 0 (the ReLU before it zeroes about half): the masks, flat."""
    masks = []

    def hook(module, args, out):
        live = args[0] != 0
        masks.append((out[live] != 0).flatten())

    handles = [m.register_forward_hook(hook) for m in model.netG.modules()
               if isinstance(m, Dropout)]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, torch.cat(masks) if masks else None


def phase_dropout(seed, smi):
    """no_dropout=False: a counted step with finite metrics, the masks'
    keep rate on the card's generator, two seeded calls equal, register
    equal to the no_dropout=True model's (the same weights), and
    eval_step and compute_visuals drawing masks too (JAX's run netG in
    training mode), each at the keep rate."""
    cfg = option_cfg(DROPOUT)
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(2, 1, cfg.crop_size, seed + 8, DEVICE)
    a, b, _ = pairs[0]

    # register runs without dropout: equal to the no_dropout=True model's,
    # whose weights the same seed draws the same
    plain = build_model(option_cfg({}), seed, DEVICE)
    with torch.no_grad():
        mine, ref = model.register(a, b), plain.register(a, b)
    reg_diff = max(float((x - y).abs().max()) for x, y in zip(mine, ref))
    del plain, mine, ref
    if reg_diff != 0.0:
        raise AssertionError(f"dropout register differs from "
                             f"no_dropout=True's by {reg_diff}")

    (_, history, launches, _), masks = dropout_masks(
        model, lambda: counted_steps(model, pairs, cfg.lr, seed, "dropout"))
    n = masks.numel()
    rate = float(masks.float().mean())
    bound = KEEP_SIGMAS * math.sqrt(0.25 / n)
    if not abs(rate - 0.5) <= bound:
        raise AssertionError(f"dropout keep rate {rate} over {n} draws, "
                             f"not 0.5 within {bound}")

    runs = []
    for _ in range(2):
        gen = torch.Generator(device=model.device).manual_seed(seed + 9)
        with torch.no_grad():
            (_, m, _), mk = dropout_masks(model, lambda: model.loss_fn(
                a, b, generator=patch_gen(seed), dropout_generator=gen))
        runs.append(({k: float(v) for k, v in m.items()}, mk))
    same_masks = torch.equal(runs[0][1], runs[1][1])
    seeded_errs = rel_errs(runs[0][0], runs[1][0], 1e-6, "dropout reseeded")
    if not same_masks:
        raise AssertionError("dropout: one seed drew two different masks")
    eval_rates = {}
    for name in ("eval_step", "compute_visuals"):
        call = getattr(model, name)
        _, mk = dropout_masks(model, lambda: call(
            a, b, generator=patch_gen(seed)))
        eval_rates[name] = float(mk.float().mean())
        bound_e = KEEP_SIGMAS * math.sqrt(0.25 / mk.numel())
        if not abs(eval_rates[name] - 0.5) <= bound_e:
            raise AssertionError(f"dropout {name}: keep rate "
                                 f"{eval_rates[name]}, not 0.5 within "
                                 f"{bound_e}")

    emit({"phase": "dropout", "config": "RegistrationConfig() with "
          "no_dropout False", "crop": cfg.crop_size, "steps": len(pairs),
          "launches": launches, "metrics_last": history[-1],
          "mask_draws": n, "keep_rate": rate, "keep_bound": bound,
          "reseeded_masks_equal": same_masks,
          "eval_paths_keep_rate": eval_rates,
          "reseeded_metrics_rel": seeded_errs,
          "register_vs_no_dropout_max_abs": reg_diff, "card": smi})
    return launches


# ------------------------------------------------------------ phase zoo
# the network zoo at RegistrationConfig()'s full width (WIDTH beside it),
# one choice a run changed from the defaults
ZOO_RUNS = {
    "netG_unet_256": dict(netG="unet_256", nce_layers=(0, 2, 4, 6)),
    "netG_resnet_cat": dict(netG="resnet_cat", nce_layers=(0, 1, 2, 3)),
    "netG_stylegan2": dict(netG="stylegan2", nce_layers=(1, 2, 3)),
    "netG_smallstylegan2": dict(netG="smallstylegan2", nce_layers=(1, 2, 3)),
    "netF_sample": dict(netF="sample"),
    "netF_global_pool": dict(netF="global_pool"),
    "netF_reshape": dict(netF="reshape"),
    "netF_strided_conv": dict(netF="strided_conv"),
    "netR_vxm_transformer": dict(netR="vxm_transformer"),
    "netR_vxm_dual": dict(netR="vxm_dual"),
    "netD_stylegan2": dict(lambda_GAN=1.0, netD="stylegan2"),
    "netD_patchstylegan2": dict(lambda_GAN=1.0, netD="patchstylegan2"),
    "netD_tilestylegan2": dict(lambda_GAN=1.0, netD="tilestylegan2"),
}
ZOO_CPU_REGISTER = ("netG", "netR")  # runs whose full-width register is
                                     # held against the CPU
# timing depth kept small (it was 3 timed steps and a median of 10 calls,
# then 2 steps before phase zoo3d came) so that the script's phases stay
# near their time with phases joint3d, bf16_3d, bf16_zoo and zoo3d beside
# them
ZOO_STEPS = 1                        # timed, after 1 warm-up
ZOO_REGISTER_REPS = 1          # (3 before spatial_options)
# the card-vs-CPU step: the CPU tests' narrow width, but unet_256 needs a
# side of 2^8, and resnet_cat's tap 0 is a ReLU's output, which at 8
# channels is all zero at some location: the JAX package's gradients are
# NaN there (the L2 norm's square root) and the port's 1e7-scale (the
# normalisation's derivative, 1 / eps), so its width is 32
ZOO_NARROW = dict(SMALL, ndf=8)
ZOO_NARROW_WIDTH = {"netG_unet_256": dict(crop_size=256),
                    "netG_resnet_cat": dict(ngf=32)}
# a metric near 0 is held absolutely: global_pool's NCE, one row an image
# and so no negative but the masked one, is ~1e-8
ZOO_METRIC_FLOOR = 1e-4


def zoo_nets(model):
    return [net for net in NETS + ("netD",)
            if getattr(model, net, None) is not None]


def zoo_narrow_step(name, change, seed):
    """One train_step at the narrow width on the card and on the CPU from
    the same weights and patch ids: metrics within PATH_TOL relative
    (absolute below ZOO_METRIC_FLOOR), each network's gradients (netD's
    from its phase) within GRAD_ENV of its max |g| on the CPU; the card's
    launches the CUT step's."""
    cfg = RegistrationConfig(**dict(ZOO_NARROW, **change,
                                    **ZOO_NARROW_WIDTH.get(name, {})))
    crop = cfg.crop_size
    gen = torch.Generator().manual_seed(seed + 3)
    a, b = (torch.tanh(2 * torch.randn((2, 1, crop, crop), generator=gen))
            for _ in range(2))
    out = {}
    for run, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = build_model(cfg, seed, dev)
        warp_cuda.reset_launches()
        m = model.train_step(a.to(dev), b.to(dev), cfg.lr,
                             generator=patch_gen(seed))
        if run == "card":
            torch.cuda.synchronize()
            check_launches(f"zoo {name} narrow step",
                           dict(warp_cuda.LAUNCHES), dict(ZERO,
                                                          **STEP_LAUNCHES))
        out[run] = ({k: float(v) for k, v in m.items()},
                    {net: [(torch.zeros_like(p) if p.grad is None
                            else p.grad).detach().cpu()
                           for p in getattr(model, net).parameters()]
                     for net in zoo_nets(model)})
        del model
    card_m, cpu_m = out["card"][0], out["cpu"][0]
    metric_errs = {k: abs(card_m[k] - v) / max(abs(v), ZOO_METRIC_FLOOR)
                   for k, v in cpu_m.items()}
    bad = {k: e for k, e in metric_errs.items() if not e <= PATH_TOL}
    if bad or card_m.keys() != cpu_m.keys():
        raise AssertionError(f"zoo {name} narrow step: card vs CPU metrics "
                             f"{bad} > {PATH_TOL}")
    grad_errs = {}
    for net, cpu_g in out["cpu"][1].items():
        if not cpu_g:                  # a parameterless netF
            continue
        scale = max(float(g.abs().max()) for g in cpu_g)
        err = max(float((x - y).abs().max())
                  for x, y in zip(out["card"][1][net], cpu_g)) / scale
        grad_errs[net] = {"net_scale": scale, "card_vs_cpu": err}
        if not (scale > 0 and err <= GRAD_ENV):
            raise AssertionError(f"zoo {name} narrow step {net}: gradients "
                                 f"off by {err} of max |g| {scale} > "
                                 f"{GRAD_ENV}")
    return {"crop": crop, "ngf": cfg.ngf, "metrics_rel": metric_errs,
            "grads": grad_errs}


def zoo_run(name, change, seed, smi, pairs):
    """One zoo choice at full width: a register call counted (and against
    the CPU for a netG or netR run), register ms by CUDA events, 1 warm-up
    + ZOO_STEPS timed train steps counted, every parameter moved, peak
    memory, then the narrow card-vs-CPU step."""
    cfg = RegistrationConfig(**dict(WIDTH, **change))
    model = build_model(cfg, seed, DEVICE)
    a, b, _ = pairs[0]
    warp_cuda.reset_launches()
    out = model.register(a, b)
    torch.cuda.synchronize()
    reg_launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"zoo {name} register", reg_launches,
                   dict(ZERO, **REGISTER_LAUNCHES))
    flow_max = float(out[3].abs().max())
    if not (flow_max > 0.5 and all(bool(o.isfinite().all()) for o in out)):
        raise AssertionError(f"zoo {name}: register outputs not finite or "
                             f"pos_flow max {flow_max} px <= 0.5")
    errs = None
    if name.split("_")[0] in ZOO_CPU_REGISTER:
        cpu = build_model(cfg, seed, "cpu")
        ref = cpu.register(a.cpu(), b.cpu())
        del cpu
        errs = {k: float((o.cpu() - r).abs().max()) for k, o, r in
                zip(("fake_B", "idt_B", "y_source", "pos_flow"), out, ref)}
        bad = {k: errs[k] for k in ("fake_B", "y_source", "pos_flow")
               if not errs[k] <= PATH_TOL}
        if bad:
            raise AssertionError(f"zoo {name}: register card vs CPU {bad} "
                                 f"> {PATH_TOL}")
    reg_ms = time_ms(lambda: model.register(a, b), reps=ZOO_REGISTER_REPS,
                     warmup=1)
    del out
    before = [(net, k, p.detach().clone()) for net in zoo_nets(model)
              for k, p in getattr(model, net).named_parameters()]
    ms, history, launches, peak = counted_steps(model, pairs, cfg.lr, seed,
                                                f"zoo {name}")
    unmoved = [f"{net}.{k}" for net, k, p0 in before
               if torch.equal(dict(getattr(model, net).named_parameters())[
                   k].detach(), p0)]
    # a parameter no loss reaches (the noise weights: no noise is drawn,
    # as in JAX) stays where it is
    unmoved = [u for u in unmoved if not u.endswith(".noise.weight")]
    if unmoved:
        raise AssertionError(f"zoo {name}: {len(unmoved)} parameters did "
                             f"not move: {unmoved[:8]}")
    nets = {net: {"type": type(getattr(model, net)).__name__,
                  "params": sum(p.numel() for p in
                                getattr(model, net).parameters())}
            for net in zoo_nets(model)}
    del model, before
    torch.cuda.empty_cache()
    narrow = zoo_narrow_step(name, change, seed)
    return {"run": name, "change": {k: list(v) if isinstance(v, tuple)
                                    else v for k, v in change.items()},
            "nets": nets, "register_launches": reg_launches,
            "register_ms_b1": reg_ms, "register_card_vs_cpu_max_abs": errs,
            "pos_flow_max_px": flow_max, "step_launches": launches,
            "step_ms_b1": ms, "ms_per_step_b1": statistics.median(ms[1:]),
            "peak_mem_gb_b1": peak / 1e9, "metrics_last": history[-1],
            "narrow_step_card_vs_cpu": narrow, "card": smi}


def phase_zoo(seed, smi, register_ms, train_ms, summary=None):
    """Every ZOO_RUNS choice at full width (zoo_run), each run's line
    printed as it ends; the launches summed over the runs' register calls
    and steps.  ``summary``, when given, is filled with each run's times
    and peak memory (phase bf16_zoo prints them beside its own)."""
    pairs = make_pairs(1 + ZOO_STEPS, 1, RegistrationConfig(
        **WIDTH).crop_size, seed + 7, DEVICE)
    reg_total, step_total = dict(ZERO), dict(ZERO)
    summary = {} if summary is None else summary
    for name, change in ZOO_RUNS.items():
        t0 = time.perf_counter()
        r = zoo_run(name, change, seed, smi, pairs)
        r["wall_s"] = time.perf_counter() - t0
        emit({"phase": "zoo", **r})
        for total, got in ((reg_total, r["register_launches"]),
                           (step_total, r["step_launches"])):
            for k, v in got.items():
                total[k] += v
        summary[name] = {"register_ms_b1": r["register_ms_b1"],
                         "ms_per_step_b1": r["ms_per_step_b1"],
                         "peak_mem_gb_b1": r["peak_mem_gb_b1"]}
    emit({"phase": "zoo", "runs": summary,
          "cut_register_ms_b1": register_ms, "cut_ms_per_step_b1": train_ms,
          "register_launches": reg_total, "step_launches": step_total,
          "card": smi})
    return {"zoo_register": reg_total, "zoo_train": step_total}


# ------------------------------------------------------------ phase cli
# what each call of the task around the engine launches, from the code:
# compute_visuals runs loss_fn without a backward (the chain + the data and
# `registered` warps) and warps the grid image into `dvf`;
# registration_stats runs flow_stats, one register; test() runs eval_step
# (loss_fn without a backward) and test.py one register_pair
VISUALS_LAUNCHES = {VF: 1, FWD: 3}
STATS_LAUNCHES = REGISTER_LAUNCHES
TEST_PAIR_LAUNCHES = {VF: 2, FWD: 3}
CLI_TRAIN, CLI_TEST = 16, 4          # pairs written, at 256^2
CLI_MAX = 8                          # --max_dataset_size of the B=1 runs
CLI_GPU = "0"                        # --gpu_ids of the card's runs
CLI_SIZE = 256
# the flags beside the options' defaults (the paper's model at full width)
CLI_FLAGS = []
# the B=1 run's cadence: --print_freq, --display_freq, --jac_freq
CLI_PRINT, CLI_DISPLAY, CLI_JAC = 1, 8, 8
CLI_B1 = ["--max_dataset_size", str(CLI_MAX), "--n_epochs", "1",
          "--n_epochs_decay", "1", "--save_epoch_freq", "1",
          "--print_freq", str(CLI_PRINT), "--display_freq", str(CLI_DISPLAY),
          "--jac_freq", str(CLI_JAC)]


def add_counts(*terms):
    """sum of n * launches over (n, launches) terms, over every kernel"""
    out = dict(ZERO)
    for n, launches in terms:
        for k, v in launches.items():
            out[k] += n * v
    return out


def cli_train_launches(steps, batch, display_freq, print_freq, jac_freq,
                       per_call=None):
    """The launches of train.main over ``steps`` steps at ``batch`` pairs a
    step: the steps, the visuals where total_iters % display_freq == 0,
    registration_stats where it is a multiple of print_freq and jac_freq.
    ``per_call``: the launches of (a step, a visuals call, a stats call),
    the 2-D task's by default."""
    step, visuals, stats = per_call or (STEP_LAUNCHES, VISUALS_LAUNCHES,
                                        STATS_LAUNCHES)
    iters = [batch * s for s in range(1, steps + 1)]
    n_vis = sum(1 for i in iters if i % display_freq == 0)
    n_stats = sum(1 for i in iters if i % print_freq == 0
                  and jac_freq > 0 and i % jac_freq == 0)
    return add_counts((steps, step), (n_vis, visuals), (n_stats, stats))


def smooth_np(rng, size, cells, channels=1):
    """(channels, size, size) float32: N(0, 1) on a cells^2 grid, bilinear."""
    coarse = torch.from_numpy(
        rng.standard_normal((1, channels, cells, cells)).astype(np.float32))
    return F.interpolate(coarse, size=(size, size), mode="bilinear",
                         align_corners=True)[0].numpy()


def anatomy(rng, size):
    """Soft elliptical blobs on a smooth background, in [0, 1] (the recipe
    of scripts/make_soak_data.py, which imports PIL)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = 0.25 + 0.1 * smooth_np(rng, size, 4)[0]
    for _ in range(int(rng.integers(6, 12))):
        cy, cx = rng.uniform(0.15 * size, 0.85 * size, 2)
        sy, sx = rng.uniform(0.03 * size, 0.15 * size, 2)
        amp = rng.uniform(0.3, 0.9) * rng.choice([-1.0, 1.0])
        img += amp * np.exp(-((yy - cy) / sy) ** 2 - ((xx - cx) / sx) ** 2)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def write_cli_data(root, seed, size):
    """scripts/make_soak_data.py's layout: {train,test}{A,B} images (A a
    ramp of the anatomy, B an inverted gamma of it, misaligned by a smooth
    flow of about +-6 px) and their quantile-binned labels, x60."""
    rng = np.random.default_rng(seed)
    for phase, n in (("train", CLI_TRAIN), ("test", CLI_TEST)):
        dirs = {k: os.path.join(root, phase + k)
                for k in ("A", "B", "A_label", "B_label")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            base = anatomy(rng, size)
            flow = torch.from_numpy(smooth_np(rng, size, 6, 2) * 6.0)[None]
            qs = np.quantile(base, [0.25, 0.5, 0.75])
            a_lab = np.digitize(base, qs).astype(np.float32) * 60
            b_src, b_lab = (torch.from_numpy(x.astype(np.float32))[None, None]
                            for x in ((1.0 - base) ** 0.6, a_lab))
            b_img = warp(b_src, flow, impl="torch")[0, 0].numpy()
            b_lab = warp(b_lab, flow, mode="nearest")[0, 0].numpy()
            name = f"pair_{i:03d}.png"
            for key, img in (("A", base ** 1.1 * 255), ("B", b_img * 255),
                             ("A_label", a_lab), ("B_label", b_lab)):
                write_png(os.path.join(dirs[key], name),
                          np.clip(img, 0, 255).astype(np.uint8))


def write_png_rows(path, img, kind):
    """An L PNG whose every row carries filter ``kind`` (3 Average, 4
    Paeth), as PIL-written files mix them: the decoder's slow rows."""
    x = img.astype(np.int64)
    left, up, upleft = (np.zeros_like(x) for _ in range(3))
    left[:, 1:], up[1:], upleft[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    if kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = (np.abs(p - v) for v in (left, up, upleft))
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    rows = np.concatenate([np.full((x.shape[0], 1), kind),
                           (x - pred) % 256], axis=1).astype(np.uint8)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", x.shape[1],
                                             x.shape[0], 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def decode_ms(paths):
    """ms of read_png on each file, in turn."""
    out = []
    for p in paths:
        t0 = time.perf_counter()
        read_png(p, mode="L")
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def state_tensors(task):
    """Every tensor of a task's networks and Adam states (netD's too), on
    the CPU."""
    out = {f"{n}.{k}": v.detach().cpu() for n, net in task._nets().items()
           for k, v in net.state_dict().items()}
    eng = task.engine
    for tag, opt in (("adam", eng.optimizer),
                     ("adamD", getattr(eng, "optimizer_D", None))):
        for i, st in (opt.state_dict()["state"].items() if opt else ()):
            out.update({f"{tag}.{i}.{k}": v.detach().cpu()
                        for k, v in st.items()})
    return out


def losses_of(ck):
    """loss_history.jsonl's records; raises on a non-finite loss."""
    with open(os.path.join(ck, "loss_history.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    bad = [(r["epoch"], k) for r in recs for k, v in r["losses"].items()
           if not math.isfinite(v)]
    if not recs or bad:
        raise AssertionError(f"{ck}: no losses, or non-finite ones {bad}")
    return recs


def run_counted(log, fn, argv):
    """``fn(argv)`` with its prints in ``log``; (result, launches)."""
    torch.cuda.synchronize()
    warp_cuda.reset_launches()
    with contextlib.redirect_stdout(log):
        out = fn(argv)
    torch.cuda.synchronize()
    return out, dict(warp_cuda.LAUNCHES)


def check_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got} kernel launches, expected "
                             f"{want}")


def phase_cli(seed, smi, engine_ms):
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with open(os.path.join(root, "cli.log"), "w") as log:
            return cli_paths(root, log, seed, smi, engine_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def cli_paths(root, log, seed, smi, engine_ms):
    """The 2-D command line at full width, in-process (its launches
    counted): train, resume, card vs CPU, test, evaluate, train at B=8."""
    data, ck_dir = os.path.join(root, "data"), os.path.join(root, "ck")
    t0 = time.perf_counter()
    write_cli_data(data, seed, CLI_SIZE)
    write_s = time.perf_counter() - t0
    common = ["--dataroot", data, "--checkpoints_dir", ck_dir, "--seed",
              str(seed), *CLI_FLAGS]
    card = ["--gpu_ids", CLI_GPU]
    ck = os.path.join(ck_dir, "cli")

    # train at B=1: CLI_MAX pairs x 2 epochs
    trained, launches_train = run_counted(
        log, train_cli.main, common + card + ["--name", "cli", *CLI_B1])
    task = trained["model"]
    step_s, data_s = trained["step_s"], trained["data_s"]
    steps = len(step_s)
    want = cli_train_launches(steps, 1, CLI_DISPLAY, CLI_PRINT, CLI_JAC)
    check_launches(f"cli train, {steps} steps", launches_train, want)
    recs = losses_of(ck)
    files = sorted(os.listdir(ck))
    need = ([f"{e}_net_{n}.pth" for e in ("1", "2", "latest") for n in "GFR"]
            + [f"{e}_optim.pth" for e in ("1", "2", "latest")]
            + ["loss_log.txt"])
    missing = [f for f in need if f not in files]
    if missing or not os.path.isfile(os.path.join(ck, "web", "index.html")):
        raise AssertionError(f"cli train wrote {files}; missing {missing} "
                             f"or web/index.html")

    # checkpoints: save time and size; a fresh task on the card loads
    # `latest` equal, bit for bit, to the trained task
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.save_networks("probe")
    save_ms = (time.perf_counter() - t0) * 1e3
    probe = [os.path.join(ck, f) for f in os.listdir(ck)
             if f.startswith("probe_")]
    ckpt_bytes = sum(os.path.getsize(p) for p in probe)
    for p in probe:
        os.remove(p)
    with contextlib.redirect_stdout(log):
        opt = TrainOptions(common + card + ["--name", "cli",
                                            "--continue_train"]).parse()
    fresh = RegistrationTask(opt)
    t0 = time.perf_counter()
    fresh.setup(opt)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    mine, ref = state_tensors(fresh), state_tensors(task)
    unequal = [k for k in ref if k not in mine
               or not torch.equal(mine[k], ref[k])]
    if unequal or mine.keys() != ref.keys() or fresh.step != task.step:
        raise AssertionError(f"reloaded `latest` differs from the trained "
                             f"task: {unequal[:8]} (step {fresh.step} vs "
                             f"{task.step})")
    del fresh, mine, ref, task, trained
    torch.cuda.empty_cache()

    # resume: one more epoch
    resumed, launches_resume = run_counted(
        log, train_cli.main, common + card + [
            "--name", "cli", "--continue_train", "--epoch_count", "3",
            "--n_epochs", "1", "--n_epochs_decay", "2", "--save_epoch_freq",
            "1", "--print_freq", "1", "--max_dataset_size", str(CLI_MAX)])
    check_launches("cli resume", launches_resume,
                   cli_train_launches(len(resumed["step_s"]), 1, 400, 1, 0))
    recs_resume = [r for r in losses_of(ck) if r["epoch"] == 3]
    if len(recs_resume) != CLI_MAX:
        raise AssertionError(f"resume logged {len(recs_resume)} steps")
    del resumed
    torch.cuda.empty_cache()

    # card vs CPU: `latest` (epoch 3) loaded by a test task on each
    test_common = common + ["--name", "cli"]
    pair = [torch.from_numpy(to_array(read_png(
        os.path.join(data, f"test{s}", "pair_000.png"), mode="L")))[None]
        for s in "AB"]
    outs = {}
    for dev, ids in (("card", CLI_GPU), ("cpu", "-1")):
        with contextlib.redirect_stdout(log):
            opt = TestOptions(test_common + ["--gpu_ids", ids]).parse()
            t = RegistrationTask(opt)
            t.setup(opt)
        outs[dev] = [o.cpu() for o in t.register_pair(
            *(x.to(t.device) for x in pair))]
        del t
    names = ("fake_B", "idt_B", "y_source", "pos_flow")
    errs = {n: float((a - b).abs().max())
            for n, a, b in zip(names, outs["card"], outs["cpu"])}
    for n in ("fake_B", "y_source", "pos_flow"):
        if not errs[n] <= PATH_TOL:
            raise AssertionError(f"cli {n}: card vs CPU {errs[n]} > "
                                 f"{PATH_TOL}")
    del outs
    torch.cuda.empty_cache()

    # test: CLI_TEST pairs
    results = os.path.join(root, "results")
    tested, launches_test = run_counted(
        log, test_cli.main, test_common + card + [
            "--results_dir", results, "--num_test", str(CLI_TEST)])
    check_launches("cli test", launches_test,
                   add_counts((CLI_TEST, TEST_PAIR_LAUNCHES)))
    for i in range(CLI_TEST):
        name = f"pair_{i:03d}.png"
        warped = read_png(os.path.join(data, "deform_label", name))
        orig = read_png(os.path.join(data, "trainA_label", name))
        if not set(np.unique(warped)) <= set(np.unique(orig)):
            raise AssertionError(f"deform_label/{name}: values "
                                 f"{np.unique(warped)} not all in "
                                 f"{np.unique(orig)}")
    n_warped = len(os.listdir(os.path.join(data, "deform_trainA")))
    with open(os.path.join(data, "jac_vis", "stats.jsonl")) as f:
        n_stats = len(f.readlines())
    index = os.path.join(results, "cli", "test_latest", "index.html")
    if n_warped != CLI_TEST or n_stats != CLI_TEST or \
            not os.path.isfile(index):
        raise AssertionError(f"cli test: {n_warped} deform_trainA PNGs, "
                             f"{n_stats} jac_vis stats, index "
                             f"{os.path.isfile(index)}")

    # evaluate: the test pairs' paired labels
    scored, launches_eval = run_counted(
        log, eval_cli.main, ["--dataroot", data, "--name", "cli",
                             "--checkpoints_dir", ck_dir, "--gpu_ids",
                             CLI_GPU, "--num_test", str(CLI_TEST),
                             "--crop_size", str(CLI_SIZE)])
    check_launches("cli evaluate", launches_eval,
                   add_counts((CLI_TEST, REGISTER_LAUNCHES)))
    summary = scored["summary"]
    keys = ("mean_dice_before", "mean_dice_after", "mean_hd95_before",
            "mean_hd95_after", "mean_ncc_global", "mean_ncc_windowed",
            "mean_psnr", "mean_folding_fraction")
    if summary.get("n_pairs") != CLI_TEST or not all(
            math.isfinite(summary.get(k, float("nan"))) for k in keys):
        raise AssertionError(f"cli evaluate summary {summary}")

    options = cli_option_paths(root, log, common, card, ck_dir)
    zoo = cli_zoo_paths(root, log, common, card, ck_dir)
    options = {k: dict(options[k], **zoo[k]) for k in options}

    # train at B=8: every pair, one epoch
    b8, launches_b8 = run_counted(
        log, train_cli.main, common + card + [
            "--name", "cli_b8", "--batch_size", "8", "--n_epochs", "1",
            "--n_epochs_decay", "0", "--print_freq", "8",
            "--display_freq", "1000", "--save_epoch_freq", "1"])
    step_s_b8 = b8["step_s"]
    steps_b8 = len(step_s_b8)
    check_launches("cli train B=8", launches_b8,
                   cli_train_launches(steps_b8, 8, 1000, 8, 0))
    if steps_b8 != CLI_TRAIN // 8:
        raise AssertionError(f"B=8: {steps_b8} steps")
    losses_of(os.path.join(ck_dir, "cli_b8"))
    del b8
    torch.cuda.empty_cache()

    # PNG decode: the phase's files (filter None) and the same images with
    # Average or Paeth on every row
    train_pngs = [os.path.join(data, f"train{s}", f"pair_{i:03d}.png")
                  for s in "AB" for i in range(CLI_TRAIN)]
    filtered = {}
    for kind, label in ((3, "average"), (4, "paeth")):
        paths = []
        for i, src in enumerate(train_pngs[:4]):
            p = os.path.join(root, f"rows{kind}_{i}.png")
            write_png_rows(p, read_png(src), kind)
            paths.append(p)
        filtered[label] = decode_ms(paths)
    decode = {"none": decode_ms(train_pngs), **filtered}

    ms_b1 = statistics.median(step_s[1:]) * 1e3
    emit({"phase": "cli", "config": "options defaults (the paper's model: "
          "crop 256, ngf 64, resnet_9blocks, mlp_sample, 256 patches, CUT "
          "with nce_idt)", "flags": CLI_FLAGS + CLI_B1,
          "pairs": {"train": CLI_TRAIN, "test": CLI_TEST},
          "data_write_s": write_s,
          "launches": {"cli_train": launches_train,
                       "cli_resume": launches_resume,
                       "cli_test": launches_test,
                       "cli_evaluate": launches_eval,
                       "cli_train_b8": launches_b8, **options["launches"]},
          "launches_per_test_pair": TEST_PAIR_LAUNCHES,
          "steps_b1": steps, "card_vs_cpu_max_abs": errs,
          "losses_first": recs[0]["losses"],
          "losses_resumed_last": recs_resume[-1]["losses"],
          "evaluate_summary": summary,
          "ms_per_step_b1": ms_b1, "engine_ms_per_step_b1": engine_ms,
          "step_ms_b1": [x * 1e3 for x in step_s],
          "data_ms_per_step": statistics.median(data_s) * 1e3,
          "data_ms": [x * 1e3 for x in data_s],
          "png_decode_ms_per_image": {k: statistics.median(v)
                                      for k, v in decode.items()},
          "png_decode_ms_max": {k: max(v) for k, v in decode.items()},
          "ckpt_save_ms": save_ms, "ckpt_load_ms": load_ms,
          "ckpt_bytes": ckpt_bytes,
          "test_ms_per_pair": statistics.median(tested["pair_s"]) * 1e3,
          "evaluate_ms_per_pair": statistics.median(scored["pair_s"]) * 1e3,
          "step_ms_b8": [x * 1e3 for x in step_s_b8],
          "train_pairs_per_s_b8": 8e3 / (step_s_b8[-1] * 1e3),
          "options": options["summary"], "card": smi})
    return {"cli_train": launches_train, "cli_test": launches_test,
            **options["launches"]}


# the command line's training options: a few steps each at B=1
CLI_OPTION_RUNS = {"cli_fastcut": ["--CUT_mode", "FastCUT"],
                   "cli_gan": ["--lambda_GAN", "1"]}
CLI_OPTION_STEPS = 2


def cli_short_run(log, common, card, name, flags, ck_dir):
    """``train`` with ``flags`` for CLI_OPTION_STEPS steps (launches
    exact): (trained, launches, summary)."""
    trained, launches = run_counted(
        log, train_cli.main, common + card + flags + [
            "--name", name, "--max_dataset_size", str(CLI_OPTION_STEPS),
            "--n_epochs", "1", "--n_epochs_decay", "0",
            "--save_epoch_freq", "1", "--print_freq", "1",
            "--display_freq", "1000", "--jac_freq", "0"])
    steps = len(trained["step_s"])
    check_launches(f"{name}, {steps} steps", launches,
                   cli_train_launches(steps, 1, 1000, 1, 0))
    recs = losses_of(os.path.join(ck_dir, name))
    return trained, launches, {"flags": flags, "steps": steps,
                               "step_ms": [x * 1e3 for x in
                                           trained["step_s"]],
                               "losses_last": recs[-1]["losses"]}


def cli_reload_and_test(root, log, common, card, name, flags, task):
    """``name``'s `latest` reloaded into a fresh task on the card bit for
    bit (weights, Adam states, step), then ``test`` of one pair (launches
    exact): (test launches, summary)."""
    with contextlib.redirect_stdout(log):
        opt = TrainOptions(common + card + flags + [
            "--name", name, "--continue_train"]).parse()
    fresh = RegistrationTask(opt)
    fresh.setup(opt)
    mine, ref = state_tensors(fresh), state_tensors(task)
    unequal = [k for k in ref if k not in mine
               or not torch.equal(mine[k], ref[k])]
    if unequal or mine.keys() != ref.keys() or fresh.step != task.step:
        raise AssertionError(f"{name}: reloaded `latest` differs: "
                             f"{unequal[:8]} (step {fresh.step} vs "
                             f"{task.step})")
    summary = {"reload_tensors_equal": len(mine),
               "reload_has_adamD": any(k.startswith("adamD.") for k in mine)}
    del fresh, mine, ref
    torch.cuda.empty_cache()
    tested, launches = run_counted(
        log, test_cli.main, common + card + flags + [
            "--name", name, "--results_dir",
            os.path.join(root, f"results_{name}"), "--num_test", "1"])
    check_launches(f"{name} test", launches,
                   add_counts((1, TEST_PAIR_LAUNCHES)))
    summary["test_ms_per_pair"] = tested["pair_s"][0] * 1e3
    return launches, summary


def cli_option_paths(root, log, common, card, ck_dir):
    """``train --CUT_mode FastCUT`` and ``train --lambda_GAN 1``,
    CLI_OPTION_STEPS steps each (launches exact); the GAN run's `latest`
    (net_D and netD's Adam state with the rest) reloaded on the card bit
    for bit; ``test`` of it."""
    launches, summary = {}, {}
    for name, flags in CLI_OPTION_RUNS.items():
        trained, launches[name], summary[name] = cli_short_run(
            log, common, card, name, flags, ck_dir)
        task = trained["model"]
        del trained
    gan_ck = os.path.join(ck_dir, "cli_gan")
    if not os.path.isfile(os.path.join(gan_ck, "latest_net_D.pth")):
        raise AssertionError(f"cli_gan wrote {sorted(os.listdir(gan_ck))}")
    launches["cli_gan_test"], more = cli_reload_and_test(
        root, log, common, card, "cli_gan", CLI_OPTION_RUNS["cli_gan"], task)
    if not more["reload_has_adamD"]:
        raise AssertionError("cli_gan: `latest` holds no netD Adam state")
    summary["cli_gan"].update(more)
    return {"launches": launches, "summary": summary}


# the zoo through the command line: CLI_OPTION_STEPS steps each, `latest`
# reloaded bit for bit, one test pair
CLI_ZOO_RUNS = {
    "cli_zoo_unet": ["--netG", "unet_256", "--nce_layers", "0,2,4,6",
                     "--netR", "vxm_transformer", "--netF", "reshape"],
    "cli_zoo_stylegan2": ["--netG", "stylegan2", "--nce_layers", "1,2,3",
                          "--netR", "vxm_dual", "--lambda_GAN", "1",
                          "--netD", "tilestylegan2"],
}


def cli_zoo_paths(root, log, common, card, ck_dir):
    """Each CLI_ZOO_RUNS run: train (launches exact), `latest` reloaded
    bit-equal, test of one pair (launches exact)."""
    launches, summary = {}, {}
    for name, flags in CLI_ZOO_RUNS.items():
        trained, launches[name], summary[name] = cli_short_run(
            log, common, card, name, flags, ck_dir)
        task = trained["model"]
        del trained
        launches[f"{name}_test"], more = cli_reload_and_test(
            root, log, common, card, name, flags, task)
        summary[name].update(more)
        del task
        torch.cuda.empty_cache()
    return {"launches": launches, "summary": summary}


# ------------------------------------------------------------ phase 6
KERNEL3D_CASES = [
    # name, (B, C, D, H, W), flow kind, flow scale (voxels), dsrc wanted,
    # src is flow
    ("vecint_step", (1, 3, 80, 80, 80), "smooth", 3.0, True, True),
    ("data_warp", (1, 1, 160, 160, 160), "smooth", 3.0, False, False),
    ("odd_shape", (2, 3, 17, 33, 45), "smooth", 2.0, True, False),
    ("violent", (1, 1, 40, 40, 40), "noise", 25.0, True, False),
    ("zero_flow", (1, 2, 32, 48, 64), "smooth", 0.0, True, False),
    ("collapse", (1, 3, 80, 80, 80), "collapse", 0.95, True, False),
    # the 3-D joint step at 128^3: `registered` (dsrc into netG; a field of
    # about a voxel) and the stacked data warp at B=2 (dflow alone)
    ("joint_registered", (1, 1, 128, 128, 128), "smooth", 0.3, True, False),
    ("joint_data_warp", (2, 1, 128, 128, 128), "smooth", 0.3, False, False),
]
# the single warps' cases of the kernels line: B3 and B4 run on the
# VxmEngine's path as the 160^3 data warp (VecInt's steps run in the chain
# kernels); B5 runs on the 3-D joint step alone, as `registered`'s source
# gradient
MAIN3D_CASE = {FWD3D: "data_warp", DFLOW3D: "data_warp",
               DSRC3D: "joint_registered"}
# the cases whose device time a launch is always measured
DEVICE3D_CASES = ("vecint_step", "data_warp", "joint_registered")
# ~18 flops a voxel for coordinates and weights; per channel the forward's
# 8 corners x (3 mul + 1 add), dflow's 8 x (7 mul + 3 add), dsrc's 8 x
# (3 mul + 1 add into its source voxel's sum); 23 to combine dflow's terms
FLOPS3D = {FWD3D: (18, 32), DFLOW3D: (41, 80), DSRC3D: (18, 32)}


def smooth_field3d(shape, scale, gen, device):
    """(B, C, D, H, W) smooth random field of about +-scale."""
    B, C, *spatial = shape
    coarse = torch.randn((B, C, *(max(n // 16, 2) for n in spatial)),
                         generator=gen, device=device)
    return F.interpolate(coarse, size=tuple(spatial), mode="trilinear",
                         align_corners=True) * scale


def warp3d_bound(name, B, C, N, alias):
    """Least time for a 3-D kernel's work over B*N voxels: each input read
    once (src is the flow when ``alias``), each output written once."""
    flow, vals = 3 * B * N, B * C * N
    src = 0 if alias else vals
    nbytes = 4 * {FWD3D: flow + src + vals,
                  DFLOW3D: flow + src + vals + flow,
                  DSRC3D: flow + vals + vals}[name]
    per_voxel, per_channel = FLOPS3D[name]
    return bound(nbytes, B * N * per_voxel + vals * per_channel)


def grid3d(flow):
    """grid_sample's normalised (x, y, z) grid for the pixel flow."""
    D, H, W = flow.shape[2:]
    locs = identity_grid((D, H, W), device=flow.device)[None] + flow
    return torch.stack([2 * (locs[:, 2] / (W - 1) - 0.5),
                        2 * (locs[:, 1] / (H - 1) - 0.5),
                        2 * (locs[:, 0] / (D - 1) - 0.5)], dim=-1)


def library3d_calls(src, flow, g):
    """The PyTorch calls that compute the same functions (the yardsticks):
    grid_sample on 5-D input and grid_sampler_3d_backward with its output
    mask, on the normalised grid built beforehand; and the dflow of the
    latter in voxel units."""
    D, H, W = flow.shape[2:]
    grid = grid3d(flow)

    def bwd(mask):
        return lambda: torch.ops.aten.grid_sampler_3d_backward(
            g, src, grid, 0, 0, True, mask)

    dgrid = bwd([False, True])()[1]
    dflow = torch.stack([dgrid[..., 2] * (2 / (D - 1)),
                         dgrid[..., 1] * (2 / (H - 1)),
                         dgrid[..., 0] * (2 / (W - 1))], dim=1)
    return {FWD3D: lambda: F.grid_sample(src, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
            DFLOW3D: bwd([False, True]), DSRC3D: bwd([True, False])}, dflow


def device_us(fn, name=None, calls=10, windows=3):
    """Device time from the profiler over ``calls`` calls of ``fn``: a
    launch of the kernel ``name``, or, with no name, every kernel of one
    call.  The profiler sometimes records none of a window's kernels; then
    the next window is tried, up to ``windows`` (None if none saw one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (name is None or name in e.key)]
        count = sum(e.count for e in hits) if name else calls * bool(hits)
        if count:
            return sum(e.device_time_total for e in hits) / count
    return None


def dsrc3d_checks(flow, g, out, kernel, device):
    """B5's extra checks and yardsticks: a second call and the plain binned
    sum bit for bit, the yardsticks' results and times (device us of a whole
    call, memsets included, beside B5's, when ``device``)."""
    again = kernel()
    binned = warp3d_dsrc_binned_plain(flow, g)
    yards = {e: yard_dsrc3d(e, flow, g) for e in ("phased", "scatter64")}
    row = {"bit_reproducible": torch.equal(out, again),
           "binned_max_abs_err": float((out - binned).abs().max()),
           "yardsticks_equal": all(torch.equal(fn(), out)
                                   for fn in yards.values())}
    for e, fn in yards.items():
        row[f"{e}_ms"] = time_ms(fn, reps=50)
    if device:
        row["device_us_per_call"] = device_us(kernel)
        for e, fn in yards.items():
            row[f"{e}_device_us_per_call"] = device_us(fn)
        row["phased_us_by_phase"] = phase_us(yards["phased"])
    return row


def phase_us(call, reps=20):
    """Device us of each of B5's 4 phases (count, scan, place, gather; the
    first with its zeroing) as the phased yardstick launches them one by
    one: CUDA events around each launch, median of ``reps`` calls."""
    for p in range(4):
        call(p)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
             for _ in range(reps)]
    for m in marks:
        for p in range(4):
            m[p].record()
            call(p)
        m[4].record()
    torch.cuda.synchronize()
    return [statistics.median(m[p].elapsed_time(m[p + 1]) for m in marks)
            * 1e3 for p in range(4)]


def phase_kernel3d(seed, profile):
    """Each 3-D kernel against its plain version on the card: forward max-abs
    <= 1e-5 (the zero flow exactly the source), dflow <= 1e-5, dsrc <= 1e-5
    * max(1, max|dsrc|), bitwise the same over two calls and as the plain
    binned sum; timed beside its bound, its plain version, the library call
    and, for dsrc, the two yardsticks (bit-equal to it too)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    rows = {FWD3D: {}, DFLOW3D: {}, DSRC3D: {}}
    for name, shape, kind, scale, need_dsrc, alias in KERNEL3D_CASES:
        B, C, D, H, W = shape
        N = D * H * W
        if kind == "smooth":
            flow = smooth_field3d((B, 3, D, H, W), scale, gen, dev)
        elif kind == "collapse":
            flow = collapse_field((B, 3, D, H, W), scale, dev)
        else:
            flow = torch.randn((B, 3, D, H, W), generator=gen,
                               device=dev) * scale
        src = flow if alias else torch.randn(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        flow_max = float(flow.abs().max())
        kernels = {FWD3D: lambda: warp_cuda.warp3d_cuda(src, flow),
                   DFLOW3D: lambda: warp_cuda.warp3d_bwd_dflow_cuda(
                       src, flow, g),
                   DSRC3D: lambda: warp_cuda.warp3d_bwd_dsrc_cuda(flow, g)}
        plains = {FWD3D: lambda: warp(src, flow, impl="torch"),
                  DFLOW3D: lambda: warp_bwd_plain(src, flow, g,
                                                  need_dsrc=False)[1],
                  DSRC3D: lambda: warp_bwd_plain(src, flow, g,
                                                 need_dflow=False)[0]}
        library, lib_dflow = library3d_calls(src, flow, g)
        if not need_dsrc:          # the data warp: dflow alone, as in a step
            del kernels[DSRC3D]
        outs = {k: fn() for k, fn in kernels.items()}
        torch.cuda.synchronize()
        refs = {k: plains[k]() for k in kernels}
        torch.cuda.synchronize()
        if scale == 0.0 and not torch.equal(outs[FWD3D], src):
            raise AssertionError("warp3d kernel: a zero flow does not copy "
                                 "the source exactly")
        outside = float((outs[FWD3D] == 0).float().mean())
        for k in kernels:
            err = float((outs[k] - refs[k]).abs().max())
            tol = KERNEL_TOL * (max(1.0, float(refs[k].abs().max()))
                                if k == DSRC3D else 1.0)
            bound_ms, bound_by = warp3d_bound(k, B, C, N, alias)
            row = {"case": name, "shape": list(shape), "flow": kind,
                   "flow_px": scale, "src_is_flow": alias,
                   "flow_max_vox": flow_max,
                   "max_abs_err": err, "tol": tol,
                   "zero_fraction": outside,
                   "ms": time_ms(kernels[k], reps=50),
                   "plain_ms": time_ms(plains[k], reps=10, warmup=2),
                   "library_ms": time_ms(library[k], reps=50),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if k == FWD3D:
                row["library_max_abs_err"] = float(
                    (library[k]() - refs[k]).abs().max())
            elif k == DFLOW3D:
                row["library_max_abs_err"] = float(
                    (lib_dflow - refs[k]).abs().max())
            else:
                row.update(dsrc3d_checks(flow, g, outs[k], kernels[k],
                                         profile or name in DEVICE3D_CASES))
            if profile or name in DEVICE3D_CASES:
                row["device_us_per_launch"] = device_us(kernels[k], k)
                row["library_device_us_per_launch"] = device_us(
                    library[k], "grid_sampler_3d")
                if row["device_us_per_launch"]:    # None: no record seen
                    row["share_of_bound"] = (bound_ms * 1e3
                                             / row["device_us_per_launch"])
            emit({"phase": "kernel3d", "kernel": k, **row})
            if not err <= tol:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on {name}: {err} > {tol}")
            if k == DSRC3D and not (row["bit_reproducible"]
                                    and row["binned_max_abs_err"] == 0.0
                                    and row["yardsticks_equal"]):
                raise AssertionError(f"{k} on {name}: not bitwise the same "
                                     f"over two calls, as the binned plain "
                                     f"sum and as its yardsticks: {row}")
            rows[k][name] = row
        del src, flow, g, outs, refs, library, lib_dflow
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 7
# a 3-D register call: VecInt's chain + the data warp; a train step: each
# forward and backward (the data warp's source needs no gradient: no dsrc)
REG3D = {VF3: 1, FWD3D: 1}
STEP3D = {VF3: 1, FWD3D: 1, VB3: 1, DFLOW3D: 1}
REG3D_CALLS = 4
SMALL3D = dict(vol_size=64, enc=(8, 16, 16, 16),
               dec=(16, 16, 16, 16, 16, 8, 8))
CONVERGE_STEPS = 20


def make_volume_pairs(n, size, seed, device):
    """Seeded textured volume pairs (source, target), (1, 1, S, S, S): the
    target is smooth noise in three octaves through a tanh, the source the
    target warped (plain version) by a smooth field of a few voxels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = []
    for _ in range(n):
        tex = sum(F.interpolate(
            torch.randn((1, 1) + (max(size // k, 2),) * 3, generator=gen,
                        device=device), size=(size,) * 3, mode="trilinear",
            align_corners=True) * (8 / k) for k in (8, 16, 32))
        target = torch.tanh(tex)
        field = smooth_field3d((1, 3) + (size,) * 3, 3.0, gen, device)
        pairs.append((warp(target, field, impl="torch"), target))
    return pairs


def build_engine(cfg, seed, device, gain=FLOW_GAIN):
    eng = VxmEngine(cfg, device=device, seed=seed)
    with torch.no_grad():
        eng.netR.flow.weight.mul_(gain)
    return eng


def small3d_grads_vs_cpu(seed):
    """A reduced-size 3-D loss and backward (64^3, enc (8,16,16,16)) on the
    card against the CPU: gradients within GRAD_ENV of each tensor's max
    |g| of the CPU in float32 and GRAD_ENV_F64 of the CPU in float64;
    the STEP3D kernel launches on the card."""
    cfg = VxmConfig(**SMALL3D)
    (src, tgt), = make_volume_pairs(1, cfg.vol_size, seed + 9, "cpu")
    grads = {}
    for run, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        eng = build_engine(cfg, seed, dev)
        eng.netR.to(dtype)
        warp_cuda.reset_launches()
        total, _ = eng.loss_fn(src.to(dev, dtype), tgt.to(dev, dtype))
        total.backward()
        if run == "card":
            torch.cuda.synchronize()
            if warp_cuda.LAUNCHES != dict(ZERO, **STEP3D):
                raise AssertionError(f"small 3-D step: {warp_cuda.LAUNCHES} "
                                     f"launches, expected {STEP3D}")
        grads[run] = {k: p.grad.detach().cpu().double()
                      for k, p in eng.netR.named_parameters()}
    worst = {"card_vs_cpu": 0.0, "card_vs_f64": 0.0, "cpu_vs_f64": 0.0}
    for k, exact in grads["cpu_f64"].items():
        scale = float(exact.abs().max())
        rel = {"card_vs_cpu": float((grads["card"][k] - grads["cpu"][k])
                                    .abs().max()) / scale,
               "card_vs_f64": float((grads["card"][k] - exact).abs().max())
               / scale,
               "cpu_vs_f64": float((grads["cpu"][k] - exact).abs().max())
               / scale}
        worst = {r: max(worst[r], v) for r, v in rel.items()}
        if not (rel["card_vs_cpu"] <= GRAD_ENV
                and rel["card_vs_f64"] <= GRAD_ENV_F64):
            raise AssertionError(f"small 3-D step {k}: card gradients off by "
                                 f"{rel} (relative to max |g|): bars "
                                 f"{GRAD_ENV} (CPU), {GRAD_ENV_F64} "
                                 f"(float64)")
    return worst


def phase_vxm3d(seed, smi):
    """VxmConfig() at full width (160^3): register and train through the
    3-D kernels, against the CPU, timed."""
    cfg = VxmConfig()
    S = cfg.vol_size
    eng = build_engine(cfg, seed, DEVICE)
    pairs = make_volume_pairs(1 + TRAIN_STEPS, S, seed + 8, DEVICE)

    # the inference path, counted
    warp_cuda.reset_launches()
    outs = [eng.register(s, t) for s, t in pairs[:REG3D_CALLS]]
    torch.cuda.synchronize()
    reg_launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * REG3D_CALLS for k, v in REG3D.items()}
    if reg_launches != dict(ZERO, **want):
        raise AssertionError(f"{reg_launches} warp launches over "
                             f"{REG3D_CALLS} 3-D register calls, expected "
                             f"{want}")
    for y, flow in outs:
        if (tuple(y.shape) != (1, 1, S, S, S)
                or tuple(flow.shape) != (1, 3, S, S, S)
                or not bool(y.isfinite().all() & flow.isfinite().all())):
            raise AssertionError(f"register: shapes {tuple(y.shape)}, "
                                 f"{tuple(flow.shape)} or not finite")
    flow_max = max(float(f.abs().max()) for _, f in outs)
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} voxels: the field "
                             f"does not deform, the warps test nothing")
    stats = {k: float(v) for k, v in eng.flow_stats(*pairs[0]).items()}
    metrics_card = {k: float(v) for k, v in eng.eval_step(*pairs[0]).items()}

    # the same weights on the CPU: one register, one eval_step
    cpu = build_engine(cfg, seed, "cpu")
    s_cpu, t_cpu = (x.cpu() for x in pairs[0])
    t1 = time.perf_counter()
    y_ref, flow_ref = cpu.register(s_cpu, t_cpu)
    cpu_register_s = time.perf_counter() - t1
    metrics_cpu = {k: float(v) for k, v in cpu.eval_step(s_cpu,
                                                         t_cpu).items()}
    del cpu
    errs = {"y_source": float((outs[0][0].cpu() - y_ref).abs().max()),
            "pos_flow": float((outs[0][1].cpu() - flow_ref).abs().max())}
    for k, e in errs.items():
        if not e <= PATH_TOL:
            raise AssertionError(f"3-D {k}: card vs CPU {e} > {PATH_TOL}")
    metric_errs = rel_errs(metrics_card, metrics_cpu, PATH_TOL,
                           "3-D eval_step")
    del outs, y_ref, flow_ref

    # the training path, counted: 1 warm-up + TRAIN_STEPS timed steps
    before = {k: p.detach().clone() for k, p in eng.netR.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    step_ms, history = [], []
    for s, t in pairs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = eng.train_step(s, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
    train_launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * len(pairs) for k, v in STEP3D.items()}
    if train_launches != dict(ZERO, **want):
        raise AssertionError(f"{train_launches} warp launches over "
                             f"{len(pairs)} 3-D train steps, expected {want}")
    peak_train = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not v == v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite 3-D metrics (step, name): {bad}")
    unmoved = [k for k, p in eng.netR.named_parameters()
               if torch.equal(p.detach(), before[k])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} parameters did not move: "
                             f"{unmoved[:8]}")
    del before

    torch.cuda.reset_peak_memory_stats()
    s, t = pairs[0]
    reg_ms = time_ms(lambda: eng.register(s, t), reps=10, warmup=2)
    peak_register = torch.cuda.max_memory_allocated()

    # convergence: 20 steps at lr 1e-3 on one pair, from the flow head's
    # own N(0, 1e-5) init (a field near zero)
    fresh = build_engine(cfg, seed + 1, DEVICE, gain=1.0)
    totals = [float(fresh.train_step(s, t, lr=1e-3)["total"])
              for _ in range(CONVERGE_STEPS)]
    del fresh
    if not totals[-1] < totals[0]:
        raise AssertionError(f"3-D loss did not fall over {CONVERGE_STEPS} "
                             f"steps: {totals}")

    small_grad_errs = small3d_grads_vs_cpu(seed)
    ms_step = statistics.median(step_ms[1:])
    emit({"phase": "vxm3d", "config": "VxmConfig() defaults",
          "vol_size": S, "enc": list(cfg.enc), "dec": list(cfg.dec),
          "int_steps": cfg.int_steps, "int_downsize": cfg.int_downsize,
          "image_loss": cfg.image_loss, "ncc_win": cfg.ncc_win,
          "register_calls": REG3D_CALLS, "launches_register": reg_launches,
          "launches_train": train_launches, "steps": len(pairs),
          "pos_flow_max_vox": flow_max, "flow_stats": stats,
          "card_vs_cpu_max_abs": errs, "eval_card_vs_cpu_rel": metric_errs,
          "cpu_register_s": cpu_register_s,
          "metrics_first": history[0], "metrics_last": history[-1],
          "converge_lr": 1e-3, "converge_totals": totals,
          "small_step_grad_rel": small_grad_errs,
          "ms_per_register_b1": reg_ms,
          "step_ms_b1": step_ms, "ms_per_step_b1": ms_step,
          "peak_mem_gb_train": peak_train / 1e9,
          "peak_mem_gb_register": peak_register / 1e9, "card": smi})
    return eng, pairs[0], reg_launches, train_launches, ms_step


# ------------------------------------------------------------ phase 7b
# scripts/make_soak_data.py's 3-D writer (--ndims 3), copied: that script
# imports PIL at its top, which the card's machine lacks.  The same numpy
# calls in the same order, so the files are the script's bit for bit
# (tests/test_torch_volume.py holds them so).

def _upsample3d(lo, size):
    """Trilinear upsample of a small 3-D grid to (size,)*3 (successive
    per-axis linear interpolation)."""
    out = lo.astype(np.float32)
    for ax in range(3):
        n = out.shape[ax]
        pos = np.linspace(0, n - 1, size).astype(np.float32)
        i0 = np.minimum(np.floor(pos).astype(np.int64), n - 2)
        w = (pos - i0).astype(np.float32)
        a = np.take(out, i0, axis=ax)
        b = np.take(out, i0 + 1, axis=ax)
        shape = [1, 1, 1]
        shape[ax] = size
        w = w.reshape(shape)
        out = a * (1 - w) + b * w
    return out


def _smooth_noise3d(rng, size, cells, amp):
    return _upsample3d(rng.standard_normal((cells,) * 3) * amp, size)


def _anatomy3d(rng, size, texture=0.35):
    """Soft 3-D Gaussian blobs on a smooth background plus a fine texture,
    in [0, 1]."""
    zz, yy, xx = np.mgrid[0:size, 0:size, 0:size].astype(np.float32)
    img = 0.25 + 0.1 * _smooth_noise3d(rng, size, 4, 1.0)
    for _ in range(int(rng.integers(8, 16))):
        c = rng.uniform(0.15 * size, 0.85 * size, 3)
        s = rng.uniform(0.04 * size, 0.16 * size, 3)
        amp = rng.uniform(0.3, 0.9) * rng.choice([-1.0, 1.0])
        img += amp * np.exp(-((zz - c[0]) / s[0]) ** 2
                            - ((yy - c[1]) / s[1]) ** 2
                            - ((xx - c[2]) / s[2]) ** 2)
    if texture > 0:
        img += texture * _smooth_noise3d(rng, size, max(size // 8, 4), 1.0)
    img -= img.min()
    return img / max(img.max(), 1e-6)


def _warp_trilinear3d(vol, flow):
    size = vol.shape
    grid = np.mgrid[0:size[0], 0:size[1], 0:size[2]].astype(np.float32)
    pos = [np.clip(grid[i] + flow[..., i], 0, size[i] - 1) for i in range(3)]
    i0 = [np.minimum(np.floor(p).astype(np.int64), s - 2)
          for p, s in zip(pos, size)]
    w = [p - f for p, f in zip(pos, i0)]
    out = np.zeros_like(vol)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wt = ((w[0] if dz else 1 - w[0])
                      * (w[1] if dy else 1 - w[1])
                      * (w[2] if dx else 1 - w[2]))
                out += wt * vol[i0[0] + dz, i0[1] + dy, i0[2] + dx]
    return out


def _warp_nearest3d(vol, flow):
    size = vol.shape
    grid = np.mgrid[0:size[0], 0:size[1], 0:size[2]].astype(np.float32)
    idx = [np.clip(np.rint(grid[i] + flow[..., i]), 0,
                   size[i] - 1).astype(np.int64) for i in range(3)]
    return vol[idx[0], idx[1], idx[2]]


def _labels(base, n_bins=4):
    """Quantile-binned anatomy -> label map {0..n_bins-1} scaled x60."""
    qs = np.quantile(base, np.linspace(0, 1, n_bins + 1)[1:-1])
    return (np.digitize(base, qs).astype(np.uint8) * 60)


def write_volumes(out, n_train, n_test, size, seed=0, flow_amp=6.0,
                  texture=0.35):
    """make_soak_data.py --ndims 3's files: {train,test}{A,B} volumes (B
    the textured anatomy warped by a smooth flow of about +-flow_amp
    voxels) and {train,test}{A,B}_label (quantile bins of the smooth
    anatomy riding the same flow), pair_NNN.npy each."""
    rng = np.random.default_rng(seed)
    for phase, n in (("train", n_train), ("test", n_test)):
        dirs = {k: os.path.join(out, phase + k)
                for k in ("A", "B", "A_label", "B_label")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            blob = _anatomy3d(rng, size, texture=0.0)
            base = blob
            if texture > 0:
                tex = texture * _smooth_noise3d(rng, size,
                                                max(size // 8, 4), 1.0)
                base = blob + tex
                base -= base.min()
                base /= max(base.max(), 1e-6)
            flow = np.stack([_smooth_noise3d(rng, size, 6, flow_amp)
                             for _ in range(3)], -1)
            b_vol = _warp_trilinear3d(base, flow)
            a_lab = _labels(blob)
            b_lab = _warp_nearest3d(a_lab, flow)
            for key, arr in (("A", base.astype(np.float32)),
                             ("B", b_vol.astype(np.float32)),
                             ("A_label", a_lab), ("B_label", b_lab)):
                np.save(os.path.join(dirs[key], f"pair_{i:03d}.npy"), arr)


CLI3D_TRAIN, CLI3D_TEST = 4, 2       # pairs written
CLI3D_SIZE = 160                     # --vol_size (the task's default)
# the flags beside the task's defaults (enc, dec: VxmTask's), given to
# train and evaluate alike
CLI3D_FLAGS = []
# the train run's cadence: --print_freq, --display_freq, --jac_freq
CLI3D_PRINT, CLI3D_DISPLAY, CLI3D_JAC = 1, 2, 2
CLI3D_RUN = ["--n_epochs", "1", "--n_epochs_decay", "1",
             "--save_epoch_freq", "1", "--print_freq", str(CLI3D_PRINT),
             "--display_freq", str(CLI3D_DISPLAY), "--jac_freq",
             str(CLI3D_JAC)]
# a 3-D step, a get_current_visuals call (it registers the batch), a
# registration_stats call
CLI3D_PER_CALL = (STEP3D, REG3D, REG3D)
EVAL3D_PAIR_LAUNCHES = REG3D   # the label warp is nearest: the plain version


def cli3d_train_launches(steps, display_freq, print_freq, jac_freq):
    return cli_train_launches(steps, 1, display_freq, print_freq, jac_freq,
                              CLI3D_PER_CALL)


def volume_args(data, name, ck_dir, size, flags):
    return ["--dataroot", data, "--name", name, "--checkpoints_dir", ck_dir,
            "--vol_size", str(size), *flags]


def phase_cli3d(seed, smi, engine_ms):
    root = tempfile.mkdtemp(prefix="chip_smoke_cli3d_")
    try:
        with open(os.path.join(root, "cli3d.log"), "w") as log:
            return cli3d_paths(root, log, seed, smi, engine_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def finite_summary(summary, n_pairs, what):
    bad = {k: v for k, v in summary.items()
           if not math.isfinite(float(v))}
    if summary.get("n_pairs") != n_pairs or summary.get("ndims") != 3 or \
            bad or "mean_dice_after" not in summary:
        raise AssertionError(f"{what}: summary {summary}")


def cli3d_paths(root, log, seed, smi, engine_ms):
    """The 3-D command line (--model vxm --dataset_mode volume) at the
    task's defaults, in-process (its launches counted): train, reload,
    resume, card vs CPU, evaluate --ndims 3."""
    data, ck_dir = os.path.join(root, "data"), os.path.join(root, "ck")
    t0 = time.perf_counter()
    write_volumes(data, CLI3D_TRAIN, CLI3D_TEST, CLI3D_SIZE, seed)
    write_s = time.perf_counter() - t0
    common = ["--model", "vxm", "--dataset_mode", "volume", "--seed",
              str(seed), *volume_args(data, "cli3d", ck_dir, CLI3D_SIZE,
                                      CLI3D_FLAGS)]
    card = ["--gpu_ids", CLI_GPU]
    ck = os.path.join(ck_dir, "cli3d")

    # train at B=1: CLI3D_TRAIN pairs x 2 epochs
    trained, launches_train = run_counted(log, train_cli.main,
                                          common + card + CLI3D_RUN)
    task = trained["model"]
    step_s, data_s = trained["step_s"], trained["data_s"]
    steps = len(step_s)
    check_launches(f"cli3d train, {steps} steps", launches_train,
                   cli3d_train_launches(steps, CLI3D_DISPLAY, CLI3D_PRINT,
                                        CLI3D_JAC))
    if steps != 2 * CLI3D_TRAIN:
        raise AssertionError(f"cli3d train: {steps} steps")
    recs = losses_of(ck)
    n_stats = sum("fold" in r["losses"] for r in recs)
    files = sorted(os.listdir(ck))
    need = ([f"{e}_{s}.pth" for e in ("1", "2", "latest")
             for s in ("net_R", "optim")] + ["loss_log.txt"])
    missing = [f for f in need if f not in files]
    if missing or not os.path.isfile(os.path.join(ck, "web", "index.html")):
        raise AssertionError(f"cli3d train wrote {files}; missing {missing} "
                             f"or web/index.html")

    # checkpoints: save time and size; a fresh task on the card loads
    # `latest` equal, bit for bit, to the trained task
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.save_networks("probe")
    save_ms = (time.perf_counter() - t0) * 1e3
    probe = [os.path.join(ck, f) for f in os.listdir(ck)
             if f.startswith("probe_")]
    ckpt_bytes = sum(os.path.getsize(p) for p in probe)
    for p in probe:
        os.remove(p)
    with contextlib.redirect_stdout(log):
        opt = TrainOptions(common + card + ["--continue_train"]).parse()
    fresh = VxmTask(opt)
    t0 = time.perf_counter()
    fresh.setup(opt)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    mine, ref = state_tensors(fresh), state_tensors(task)
    unequal = [k for k in ref if k not in mine
               or not torch.equal(mine[k], ref[k])]
    if unequal or mine.keys() != ref.keys() or fresh.step != task.step:
        raise AssertionError(f"cli3d: reloaded `latest` differs from the "
                             f"trained task: {unequal[:8]} (step "
                             f"{fresh.step} vs {task.step})")
    n_state = len(ref)
    del fresh, mine, ref, task, trained
    torch.cuda.empty_cache()

    # resume: one more epoch
    resumed, launches_resume = run_counted(
        log, train_cli.main, common + card + [
            "--continue_train", "--epoch_count", "3", "--n_epochs", "1",
            "--n_epochs_decay", "2", "--save_epoch_freq", "1",
            "--print_freq", "1"])
    check_launches("cli3d resume", launches_resume, cli3d_train_launches(
        len(resumed["step_s"]), 400, 1, 0))
    if resumed["model"].step != 3 * CLI3D_TRAIN:
        raise AssertionError(f"cli3d resume: step {resumed['model'].step}")
    recs_resume = [r for r in losses_of(ck) if r["epoch"] == 3]
    if len(recs_resume) != CLI3D_TRAIN:
        raise AssertionError(f"cli3d resume logged {len(recs_resume)} steps")
    del resumed
    torch.cuda.empty_cache()

    # card vs CPU: `latest` (epoch 3) loaded by a test-phase task on each
    pair = [torch.from_numpy(crop_or_pad(normalize_minmax(load_volume(
        os.path.join(data, f"test{s}", "pair_000.npy"))),
        (CLI3D_SIZE,) * 3))[None, None] for s in "AB"]
    outs = {}
    for dev, ids in (("card", CLI_GPU), ("cpu", "-1")):
        with contextlib.redirect_stdout(log):
            opt = TestOptions(common + ["--gpu_ids", ids]).parse()
            t = VxmTask(opt)
            t.setup(opt)
        outs[dev] = [o.cpu() for o in t.register_pair(
            *(x.to(t.device) for x in pair))]
        del t
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(
        ("y_source", "pos_flow"), outs["card"], outs["cpu"])}
    for n, e in errs.items():
        if not e <= PATH_TOL:
            raise AssertionError(f"cli3d {n}: card vs CPU {e} > {PATH_TOL}")
    del outs
    torch.cuda.empty_cache()

    # evaluate --ndims 3 on the test pairs and their label volumes
    scored, launches_eval = run_counted(
        log, eval_cli.main, ["--ndims", "3", "--gpu_ids", CLI_GPU,
                             "--num_test", str(CLI3D_TEST),
                             *volume_args(data, "cli3d", ck_dir, CLI3D_SIZE,
                                          CLI3D_FLAGS)])
    check_launches("cli3d evaluate", launches_eval,
                   add_counts((CLI3D_TEST, EVAL3D_PAIR_LAUNCHES)))
    summary = scored["summary"]
    finite_summary(summary, CLI3D_TEST, "cli3d evaluate")
    for i, v in enumerate(scored["label_values"]):
        if not set(v["warped"]) <= set(v["moving"]):
            raise AssertionError(f"cli3d evaluate pair {i}: warped label "
                                 f"values {v['warped']} not all in "
                                 f"{v['moving']}")
    if len(scored["label_values"]) != CLI3D_TEST:
        raise AssertionError("cli3d evaluate: labels not scored")

    emit({"phase": "cli3d", "config": "VxmTask defaults (enc (16,32,32,32), "
          "dec (32,32,32,32,32,16,16), 7 integration steps at half "
          "resolution, NCC 9^3, B=1)", "vol_size": CLI3D_SIZE,
          "flags": CLI3D_FLAGS + CLI3D_RUN,
          "pairs": {"train": CLI3D_TRAIN, "test": CLI3D_TEST},
          "data_write_s": write_s,
          "launches": {"cli3d_train": launches_train,
                       "cli3d_resume": launches_resume,
                       "cli3d_eval": launches_eval},
          "steps": steps, "stats_calls": n_stats,
          "card_vs_cpu_max_abs": errs, "reload_tensors_equal": n_state,
          "losses_first": recs[0]["losses"],
          "losses_resumed_last": recs_resume[-1]["losses"],
          "evaluate_summary": summary,
          "ms_per_step_b1": statistics.median(step_s[1:]) * 1e3,
          "engine_ms_per_step_b1": engine_ms,
          "step_ms_b1": [x * 1e3 for x in step_s],
          "data_ms_per_step": statistics.median(data_s) * 1e3,
          "data_ms": [x * 1e3 for x in data_s],
          "ckpt_save_ms": save_ms, "ckpt_load_ms": load_ms,
          "ckpt_bytes": ckpt_bytes,
          "evaluate_ms_per_pair": statistics.median(scored["pair_s"]) * 1e3,
          "evaluate_dice_hd95_ms_per_pair":
              statistics.median(scored["label_s"]) * 1e3,
          "evaluate_pair_ms": [x * 1e3 for x in scored["pair_s"]],
          "card": smi})
    return {"cli3d_train": launches_train, "cli3d_eval": launches_eval}


# ------------------------------------------------------ phase joint3d
# the joint model in 3-D at full width: RegistrationConfig() at ndims=3
# (ngf 64, resnet_9blocks, mlp_sample with 256 patches, VxmDense
# (16,32,32,64,64,64)/(64,64,64,32,32,32,16), 7 steps at half resolution)
# at 128^3: the default netR's six stride-2 levels need a side that 2^6
# divides, and at 160^3 the step's saved maps would come near the card's
# memory.  `registered = warp(fake_B, pos_flow)` is the one 3-D warp whose
# source needs a gradient: B5 runs there
JOINT3D = dict(ndims=3, crop_size=128)
# the card-vs-CPU config: what the CPU runs in seconds
JOINT3D_NARROW = dict(ndims=3, crop_size=32, netG="resnet_4blocks", ngf=8,
                      vxm_enc=(8, 16, 16, 16),
                      vxm_dec=(16, 16, 16, 16, 16, 8, 8), netF_nc=16,
                      num_patches=16)
# the convergence check's config: the narrow width at 64^3
JOINT3D_CONVERGE = dict(JOINT3D_NARROW, crop_size=64)
JOINT3D_STEPS = 1              # timed, after 1 warm-up (2 before
                               # spatial_options, 3 before zoo3d)
JOINT3D_REGISTER_REPS = 1      # (3 before spatial_options, 10 before zoo3d)
JOINT3D_CONVERGE_LR = 1e-3
# a 3-D register call: the chain and the y_source warp; a 3-D joint step:
# the chain, the stacked data warp and `registered` forward; backward the
# chain, both warps' dflow and `registered`'s dsrc (fake_B's gradient)
JOINT3D_REGISTER = {VF3: 1, FWD3D: 1}
JOINT3D_STEP = {VF3: 1, FWD3D: 2, VB3: 1, DFLOW3D: 2, DSRC3D: 1}
# the flow head's gain is fitted to a field (max |pos_flow|, voxels) on
# the run's first pair: past a voxel, y_source's border voxels sample
# wholly outside the volume, where the warp gives exactly 0, and a patch
# of 0 at tap 0 (the 1-channel input) leaves netF's MLP an output of 0:
# the JAX package's gradients are NaN there (the L2 norm's square root),
# the port's the normalisation's derivative, 1 / eps = 1e7 times the
# incoming gradient.  bfloat16: a field under 1/16 voxel, where one
# bf16 ulp of the flow head's output is 2.4e-4, so that the card's and
# the CPU's bf16 convs, an ulp or three apart there, stay inside the
# pos_flow bar
JOINT3D_FIELD = 0.8
BF16_3D_FIELD = 0.05


def joint3d_pairs(n, size, seed, device):
    """n (real_A, real_B, label) volume triples at B=1, make_pairs' images
    in 3-D: smooth fields (plus noise for real_A) through a tanh, and a
    4-valued label volume.  No voxel is exactly 0 (make_volume_pairs'
    sources are 0 where their warp sampled outside): netF's MLP maps a
    1-channel tap of 0 to 0, where the JAX package's gradients are NaN
    (see JOINT3D_FIELD)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (1, 1, size, size, size)
    out = []
    for _ in range(n):
        a = torch.tanh(smooth_field3d(shape, 1.5, gen, "cpu")
                       + 0.1 * torch.randn(shape, generator=gen))
        b = torch.tanh(smooth_field3d(shape, 1.5, gen, "cpu"))
        regions = smooth_field3d(shape, 1.0, gen, "cpu")
        label = torch.bucketize(regions, torch.tensor([-0.5, 0.0, 0.5]))
        out.append(tuple(t.to(device) for t in (a, b,
                                                label.float() * 60 / 255)))
    return out


def fit_flow_head(model, a, b, field):
    """Scale the flow head of ``model`` (built at gain 1) so that its max
    |pos_flow| on (a, b) is about ``field``: one register (the N(0, 1e-5)
    head's field is near linear in its gain up to a voxel).  Returns the
    gain; build_model at that gain gives the same weights."""
    with torch.no_grad():
        gain = field / float(model.register(a, b)[3].abs().max())
        model.netR.flow.weight.mul_(gain)
    return gain


def joint3d_steps(model, pairs, lr, seed, want, what):
    """train_step over ``pairs`` (the first a warm-up), counted: (ms of
    each, metrics of each, launches, peak bytes); every step launches
    ``want`` and every metric is finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    ms, history = time_steps(model, pairs, lr, seed)
    launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"{what}, {len(pairs)} steps", launches,
                   add_counts((len(pairs), want)))
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")
    return ms, history, launches, torch.cuda.max_memory_allocated()


def joint3d_register(model, pairs, what):
    """infer.register_pair_outputs over ``pairs``, counted (each call
    JOINT3D_REGISTER), every output finite and of its shape; (outputs,
    launches, max |pos_flow|)."""
    S = model.cfg.crop_size
    torch.cuda.synchronize()
    warp_cuda.reset_launches()
    outs = [infer.register_pair_outputs(model, a, b, label=lab)
            for a, b, lab in pairs]
    torch.cuda.synchronize()
    launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"{what}, {len(pairs)} register calls", launches,
                   add_counts((len(pairs), JOINT3D_REGISTER)))
    vol = (1, 1, S, S, S)
    shapes = {"fake_B": vol, "idt_B": vol, "y_source": vol,
              "pos_flow": (1, 3, S, S, S), "jac_det": (1, S, S, S),
              "folding_fraction": (1,), "label_warped": vol}
    for o in outs:
        for k, shape in shapes.items():
            if (tuple(o[k].shape) != shape or o[k].dtype != torch.float32
                    or not bool(o[k].isfinite().all())):
                raise AssertionError(f"{what} {k}: shape {tuple(o[k].shape)}"
                                     f" (expected {shape}), {o[k].dtype} or "
                                     f"not finite")
    return outs, launches, max(float(o["pos_flow"].abs().max()) for o in outs)


def joint3d_narrow(seed, bf16, name="joint3d", change=None):
    """The narrow 3-D joint model (with a zoo run's ``change``; its cube
    ZOO3D_NARROW_CROP's for ``name``) on the card and on the CPU from the
    same weights, volumes and patch ids (the flow head fitted on the CPU
    model): register (float32 PATH_TOL max-abs; bf16 BF16_BARS), then in
    float32 one train_step (metrics PATH_TOL relative, absolute below
    ZOO_METRIC_FLOOR; each network's gradients, netD's from its phase,
    within GRAD_ENV of its max |g| on the CPU; the card's launches the 3-D
    joint step's), in bf16 loss_fn's metrics within BF16_METRIC_TOL."""
    cfg = RegistrationConfig(**{
        **JOINT3D_NARROW, **(change or {}), **(BF16 if bf16 else {}),
        "crop_size": ZOO3D_NARROW_CROP.get(name,
                                           JOINT3D_NARROW["crop_size"])})
    (a, b, lab), = joint3d_pairs(1, cfg.crop_size, seed + 11, "cpu")
    cpu = build_model(cfg, seed, "cpu", gain=1.0)
    gain = fit_flow_head(cpu, a, b, BF16_3D_FIELD if bf16 else JOINT3D_FIELD)
    models = {"card": build_model(cfg, seed, DEVICE, gain), "cpu": cpu}
    del cpu
    out = {}
    for run, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = models.pop(run)
        x, y, z = (t.to(dev) for t in (a, b, lab))
        reg = infer.register_pair_outputs(model, x, y, label=z)
        warp_cuda.reset_launches()
        if bf16:
            with torch.no_grad():
                _, m, _ = model.loss_fn(x, y, generator=patch_gen(seed))
        else:
            m = model.train_step(x, y, cfg.lr, generator=patch_gen(seed))
        if run == "card":
            torch.cuda.synchronize()
            if not bf16:
                check_launches(f"{name} narrow step",
                               dict(warp_cuda.LAUNCHES),
                               dict(ZERO, **JOINT3D_STEP))
        out[run] = ({k: v.detach().cpu() for k, v in reg.items()},
                    {k: float(v) for k, v in m.items()},
                    {} if bf16 else
                    {net: [(torch.zeros_like(p) if p.grad is None
                            else p.grad).detach().cpu()
                           for p in getattr(model, net).parameters()]
                     for net in zoo_nets(model)})
        del model
    bars = BF16_BARS if bf16 else dict.fromkeys(
        ("fake_B", "idt_B", "y_source", "pos_flow"), PATH_TOL)
    reg_errs = {k: float((out["card"][0][k] - out["cpu"][0][k]).abs().max())
                for k in bars}
    bad = {k: e for k, e in reg_errs.items() if not e <= bars[k]}
    card_m, cpu_m = out["card"][1], out["cpu"][1]
    tol = BF16_METRIC_TOL if bf16 else PATH_TOL
    metric_errs = {k: abs(card_m[k] - v) / max(abs(v), ZOO_METRIC_FLOOR)
                   for k, v in cpu_m.items()}
    bad.update({k: e for k, e in metric_errs.items() if not e <= tol})
    if bad or card_m.keys() != cpu_m.keys():
        raise AssertionError(f"{name} narrow (bf16 {bf16}): card vs "
                             f"CPU {bad} past {bars} / {tol}")
    grad_errs = {}
    for net, cpu_g in out["cpu"][2].items():
        if not cpu_g:                  # a parameterless netF
            continue
        scale = max(float(g.abs().max()) for g in cpu_g)
        err = max(float((x - y).abs().max())
                  for x, y in zip(out["card"][2][net], cpu_g)) / scale
        grad_errs[net] = {"net_scale": scale, "card_vs_cpu": err}
        if not (scale > 0 and err <= GRAD_ENV):
            raise AssertionError(f"{name} narrow step {net}: "
                                 f"gradients off by {err} of max |g| "
                                 f"{scale} > {GRAD_ENV}")
    return {"crop": cfg.crop_size, "ngf": cfg.ngf, "netG": cfg.netG,
            "flow_gain": gain,
            "pos_flow_max_vox": float(out["cpu"][0]["pos_flow"].abs().max()),
            "register_max_abs": reg_errs, "metrics_rel": metric_errs,
            "grads": grad_errs}


def joint3d_full(what, cfg, seed, pairs, steps, field):
    """One 3-D joint model at full width: built at gain 1, its flow head
    fitted to ``field`` voxels on the first pair, a register_pair_outputs
    call counted (JOINT3D_REGISTER), register ms (CUDA events, median of
    JOINT3D_REGISTER_REPS), 1 warm-up + ``steps`` timed steps counted
    (JOINT3D_STEP each), every parameter moved (netD's too; but the MLP
    of a tap of one location, whose gradient must be 0), every master
    parameter and Adam moment float32, peak memory of each part."""
    model = build_model(cfg, seed, DEVICE, gain=1.0)
    gain = fit_flow_head(model, *pairs[0][:2], field)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, reg_launches, flow_max = joint3d_register(model, pairs[:1], what)
    if not 0.5 * field < flow_max < 1.5 * field:
        raise AssertionError(f"{what}: pos_flow max {flow_max} voxels, not "
                             f"the fitted {field}")
    a, b, _ = pairs[0]
    reg_ms = time_ms(lambda: model.register(a, b),
                     reps=JOINT3D_REGISTER_REPS, warmup=1)
    peak_register = torch.cuda.max_memory_allocated()
    nets = zoo_nets(model)
    before = [(net, k, p.detach().clone()) for net in nets
              for k, p in getattr(model, net).named_parameters()]
    ms, history, launches, peak = joint3d_steps(
        model, pairs[:1 + steps], cfg.lr, seed, JOINT3D_STEP, what)
    params = {f"{net}.{k}": p for net in nets
              for k, p in getattr(model, net).named_parameters()}
    unmoved = [k for net, n, p0 in before for k in [f"{net}.{n}"]
               if torch.equal(params[k].detach(), p0)]
    # a tap of one location (unet_128's level 6 at 128^3) gives its NCE
    # one patch a volume at B=1, no negative but the masked one: a
    # constant loss, so that tap's MLP has a gradient of exactly 0 (in
    # JAX too) and stays where it is
    one_location = [f"netF.mlp_{i}." for i, shape in enumerate(
        model._tap_shapes(model.netG)) if math.prod(shape[2:]) == 1]
    still = [k for k in unmoved
             if any(k.startswith(m) for m in one_location)
             and (params[k].grad is None or not params[k].grad.any())]
    unmoved = [k for k in unmoved if k not in still]
    if unmoved:
        raise AssertionError(f"{what}: {len(unmoved)} parameters did not "
                             f"move: {unmoved[:8]}")
    float32_state(model, what)
    if model.netD is not None and not all(
            p.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype
            == torch.float32 for p, st in model.optimizer_D.state.items()):
        raise AssertionError(f"{what}: netD's master parameters or Adam "
                             f"state not float32")
    out = {"nets": {net: {"type": type(getattr(model, net)).__name__,
                          "params": sum(p.numel() for p in getattr(
                              model, net).parameters())} for net in nets},
           "flow_gain": gain, "pos_flow_max_vox": flow_max,
           "unmoved_zero_gradient": still,
           "register_launches": reg_launches, "register_ms_b1": reg_ms,
           "peak_mem_gb_register": peak_register / 1e9,
           "step_launches": launches, "step_ms_b1": ms,
           "ms_per_step_b1": statistics.median(ms[1:]),
           "peak_mem_gb_b1": peak / 1e9, "metrics_last": history[-1]}
    del model, before
    torch.cuda.empty_cache()
    return out


def float32_state(model, what):
    """Raise unless every master parameter and Adam moment is float32."""
    wrong = [n for net in NETS for n, p in getattr(model, net)
             .named_parameters() if p.dtype != torch.float32]
    wrong += [str(i) for i, st in model.optimizer.state.items()
              if not (st["exp_avg"].dtype == st["exp_avg_sq"].dtype
                      == torch.float32)]
    if wrong or not model.optimizer.state:
        raise AssertionError(f"{what}: master parameters or Adam state not "
                             f"float32: {wrong[:8]}")


def phase_joint3d(seed, smi, profile):
    """The joint model at ndims=3, 128^3, full width: register at B=1
    counted (1 chain forward + 1 B3 a call; a label volume warped) and
    timed (CUDA events, median of 3), peak memory; 1 warm-up + 2 timed
    steps counted (1 + 2 forward, 1 chain backward + 2 B4 + 1 B5), every
    metric finite and every parameter moved, peak memory; one step traced
    (device time by kernel: the chains' and B5's, the idle share); the
    narrow model card vs CPU; 20 steps of the narrow model at 64^3 on one
    pair, the total falling."""
    cfg = RegistrationConfig(**JOINT3D)
    S = cfg.crop_size
    pairs = joint3d_pairs(1 + JOINT3D_STEPS, S, seed + 10, DEVICE)
    model = build_model(cfg, seed, DEVICE, gain=1.0)
    gain = fit_flow_head(model, *pairs[0][:2], JOINT3D_FIELD)

    torch.cuda.reset_peak_memory_stats()
    outs, reg_launches, flow_max = joint3d_register(model, pairs[:2],
                                                    "joint3d")
    if not 0.5 < flow_max < 1.0:
        raise AssertionError(f"joint3d pos_flow max {flow_max} voxels: "
                             f"not the fitted {JOINT3D_FIELD}")
    labels_kept = bool(torch.isin(outs[0]["label_warped"],
                                  pairs[0][2]).all())
    if not labels_kept:
        raise AssertionError("joint3d: the nearest label warp made values "
                             "the label volume does not hold")
    a, b, _ = pairs[0]
    reg_ms = time_ms(lambda: model.register(a, b),
                     reps=JOINT3D_REGISTER_REPS, warmup=2)
    peak_register = torch.cuda.max_memory_allocated()
    folding = [float(o["folding_fraction"][0]) for o in outs]
    del outs

    before = {(net, k): p.detach().clone() for net in NETS
              for k, p in getattr(model, net).named_parameters()}
    ms, history, launches, peak = joint3d_steps(
        model, pairs, cfg.lr, seed, JOINT3D_STEP, "joint3d")
    unmoved = [f"{net}.{k}" for (net, k), p0 in before.items()
               if torch.equal(dict(getattr(model, net).named_parameters())[
                   k].detach(), p0)]
    del before
    if unmoved:
        raise AssertionError(f"joint3d: {len(unmoved)} parameters did not "
                             f"move: {unmoved[:8]}")
    gen = patch_gen(seed)
    traced = trace(lambda: model.train_step(a, b, cfg.lr, generator=gen), 1,
                   warmup=0)
    del model, pairs
    torch.cuda.empty_cache()

    narrow = joint3d_narrow(seed, bf16=False)
    conv_cfg = RegistrationConfig(**JOINT3D_CONVERGE)
    fresh = build_model(conv_cfg, seed + 1, DEVICE, gain=1.0)
    (ca, cb, _), = joint3d_pairs(1, conv_cfg.crop_size, seed + 12, DEVICE)
    totals = [float(fresh.train_step(ca, cb, JOINT3D_CONVERGE_LR,
                                     generator=patch_gen(seed))["total"])
              for _ in range(CONVERGE_STEPS)]
    del fresh
    if not totals[-1] < totals[0]:
        raise AssertionError(f"joint3d: the total did not fall over "
                             f"{CONVERGE_STEPS} steps: {totals}")
    emit({"phase": "joint3d", "config": "RegistrationConfig(ndims=3, "
          "crop_size=128)", "crop": S, "ngf": cfg.ngf, "netG": cfg.netG,
          "netF": cfg.netF, "num_patches": cfg.num_patches,
          "vxm": [list(cfg.vxm_enc), list(cfg.vxm_dec)],
          "int_steps": cfg.int_steps, "int_downsize": cfg.int_downsize,
          "flow_gain": gain, "pos_flow_max_vox": flow_max,
          "folding_fraction": folding, "labels_kept": labels_kept,
          "register_launches": reg_launches, "register_ms_b1": reg_ms,
          "peak_mem_gb_register": peak_register / 1e9,
          **step_summary(ms, history, launches, peak, None),
          "trace_step": traced, "narrow_card_vs_cpu": narrow,
          "converge": {"crop": conv_cfg.crop_size,
                       "lr": JOINT3D_CONVERGE_LR, "totals": totals},
          "card": smi})
    if profile:
        emit({"phase": "profile", "path": "joint3d_train", **traced})
    return ({"joint3d_register": reg_launches, "joint3d_train": launches},
            reg_ms, statistics.median(ms[1:]))


def phase_bf16_3d(seed, smi, register_ms, train_ms):
    """The same 3-D model in bfloat16 (the flow head scaled to a field of
    0.05 voxel): joint3d_full's register and 1 warm-up + JOINT3D_STEPS
    timed steps at full width, counted and timed beside phase joint3d's
    float32, every master parameter and Adam moment float32, peak memory;
    the narrow model card vs the CPU's bfloat16 under BF16_BARS."""
    cfg = RegistrationConfig(**JOINT3D, **BF16)
    pairs = joint3d_pairs(1 + JOINT3D_STEPS, cfg.crop_size, seed + 10,
                          DEVICE)
    full = joint3d_full("bf16_3d", cfg, seed, pairs, JOINT3D_STEPS,
                        BF16_3D_FIELD)
    del pairs
    narrow = joint3d_narrow(seed, bf16=True)
    emit({"phase": "bf16_3d", "config": "RegistrationConfig(ndims=3, "
          "crop_size=128, compute_dtype='bfloat16')", "crop": cfg.crop_size,
          **full, "f32_register_ms_b1": register_ms,
          "master_dtype": "float32", "bars": BF16_BARS,
          "f32_ms_per_step_b1": train_ms,
          "narrow_card_vs_cpu_bf16": narrow, "card": smi})
    return {"bf16_3d_register": full["register_launches"],
            "bf16_3d_train": full["step_launches"]}


def bf16_zoo_narrow(name, change, seed):
    """One zoo choice in bfloat16 at the narrow width, card vs the CPU's
    bfloat16 from the same weights: register under BF16_BARS, loss_fn
    metrics within BF16_METRIC_TOL relative (absolute below
    ZOO_METRIC_FLOOR)."""
    cfg = RegistrationConfig(**dict(ZOO_NARROW, **change, **BF16,
                                    **ZOO_NARROW_WIDTH.get(name, {})))
    crop = cfg.crop_size
    gen = torch.Generator().manual_seed(seed + 3)
    a, b = (torch.tanh(2 * torch.randn((2, 1, crop, crop), generator=gen))
            for _ in range(2))
    out = {}
    for run, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = build_model(cfg, seed, dev, BF16_GAIN)
        with torch.no_grad():
            reg = model.register(a.to(dev), b.to(dev))
            _, m, _ = model.loss_fn(a.to(dev), b.to(dev),
                                    generator=patch_gen(seed))
        out[run] = ([o.cpu() for o in reg], {k: float(v)
                                             for k, v in m.items()})
        del model
    reg_errs = {k: float((x - y).abs().max()) for k, x, y in
                zip(BF16_BARS, out["card"][0], out["cpu"][0])}
    bad = {k: e for k, e in reg_errs.items() if not e <= BF16_BARS[k]}
    card_m, cpu_m = out["card"][1], out["cpu"][1]
    metric_errs = {k: abs(card_m[k] - v) / max(abs(v), ZOO_METRIC_FLOOR)
                   for k, v in cpu_m.items()}
    bad.update({k: e for k, e in metric_errs.items()
                if not e <= BF16_METRIC_TOL})
    if bad or card_m.keys() != cpu_m.keys():
        raise AssertionError(f"bf16 zoo {name} narrow: card vs CPU {bad} "
                             f"past {BF16_BARS} / {BF16_METRIC_TOL}")
    return {"crop": crop, "ngf": cfg.ngf, "register_max_abs": reg_errs,
            "metrics_rel": metric_errs,
            "pos_flow_max_px": float(out["cpu"][0][3].abs().max())}


def phase_bf16_zoo(seed, smi, zoo_f32):
    """Every ZOO_RUNS choice in bfloat16 at full width (the flow head
    scaled to about 0.1 px): a register call counted (1 + 1), register ms
    (CUDA events, median of ZOO_REGISTER_REPS), 1 warm-up + ZOO_STEPS timed
    steps counted (the CUT step's launches), master parameters and Adam
    state float32 (netD's too), peak memory, beside the float32 zoo run of
    this run (``zoo_f32``, phase zoo's summary); then the narrow
    card-vs-CPU bf16 check (bf16_zoo_narrow).  A line a run, then a
    summary line."""
    pairs = make_pairs(1 + ZOO_STEPS, 1, RegistrationConfig(
        **WIDTH).crop_size, seed + 7, DEVICE)
    a, b, _ = pairs[0]
    reg_total, step_total, summary = dict(ZERO), dict(ZERO), {}
    for name, change in ZOO_RUNS.items():
        t0 = time.perf_counter()
        cfg = RegistrationConfig(**dict(WIDTH, **change, **BF16))
        model = build_model(cfg, seed, DEVICE, BF16_GAIN)
        warp_cuda.reset_launches()
        out = model.register(a, b)
        torch.cuda.synchronize()
        reg_launches = dict(warp_cuda.LAUNCHES)
        check_launches(f"bf16 zoo {name} register", reg_launches,
                       dict(ZERO, **REGISTER_LAUNCHES))
        if not all(o.dtype == torch.float32 and bool(o.isfinite().all())
                   for o in out):
            raise AssertionError(f"bf16 zoo {name}: register outputs not "
                                 f"finite float32")
        flow_max = float(out[3].abs().max())
        del out
        reg_ms = time_ms(lambda: model.register(a, b),
                         reps=ZOO_REGISTER_REPS, warmup=1)
        ms, history, launches, peak = counted_steps(
            model, pairs, cfg.lr, seed, f"bf16 zoo {name}")
        float32_state(model, f"bf16 zoo {name}")
        if model.netD is not None and not all(
                st["exp_avg"].dtype == torch.float32
                for st in model.optimizer_D.state.values()):
            raise AssertionError(f"bf16 zoo {name}: netD's Adam state not "
                                 f"float32")
        del model
        torch.cuda.empty_cache()
        narrow = bf16_zoo_narrow(name, change, seed)
        f32 = zoo_f32.get(name, {})
        r = {"run": name, "register_launches": reg_launches,
             "register_ms_b1": reg_ms,
             "f32_register_ms_b1": f32.get("register_ms_b1"),
             "pos_flow_max_px": flow_max, "step_launches": launches,
             "step_ms_b1": ms, "ms_per_step_b1": statistics.median(ms[1:]),
             "f32_ms_per_step_b1": f32.get("ms_per_step_b1"),
             "peak_mem_gb_b1": peak / 1e9,
             "f32_peak_mem_gb_b1": f32.get("peak_mem_gb_b1"),
             "metrics_last": history[-1], "narrow_card_vs_cpu_bf16": narrow,
             "wall_s": time.perf_counter() - t0}
        emit({"phase": "bf16_zoo", **r, "card": smi})
        for total, got in ((reg_total, reg_launches), (step_total, launches)):
            for k, v in got.items():
                total[k] += v
        summary[name] = {k: r[k] for k in (
            "register_ms_b1", "f32_register_ms_b1", "ms_per_step_b1",
            "f32_ms_per_step_b1", "peak_mem_gb_b1", "f32_peak_mem_gb_b1")}
    emit({"phase": "bf16_zoo", "runs": summary, "flow_gain": BF16_GAIN,
          "register_launches": reg_total, "step_launches": step_total,
          "card": smi})
    return {"bf16_zoo_register": reg_total, "bf16_zoo_train": step_total}


# ---------------------------------------------------------- phase zoo3d
# the joint model at 128^3, full width (phase joint3d's configuration),
# with one choice of the 3-D zoo changed a run: every network the JAX
# package builds and trains at ndims=3.  unet_256 needs a side of 2^8:
# 256^3 is the smallest cube it takes (its netR then at 256^3 too).
# strided_conv makes every output location of a tap a patch, about 30 a
# side (24,389-27,000 at 128^3), and PatchNCE's logits are that number
# squared a tap and NCE call: at 128^3 its 15 (2.2-2.7 GiB each, kept for
# the backward with their masks) do not fit beside the 52.5 GB step (on
# an 80 GB H100 the step ran out of memory with 74.3 GiB allocated), so
# it runs at 64^3, the netR's smallest cube, where two of its five taps
# are 14^3
ZOO3D_RUNS = {
    "netG_unet_128": dict(netG="unet_128", nce_layers=(0, 2, 4, 6)),
    "netG_unet_256": dict(netG="unet_256", nce_layers=(0, 2, 4, 6),
                          crop_size=256),
    "netF_global_pool": dict(netF="global_pool"),
    "netF_strided_conv": dict(netF="strided_conv", crop_size=64),
    "netR_vxm_dual": dict(netR="vxm_dual"),
    "netD_basic": dict(lambda_GAN=1.0, netD="basic", n_layers_D=3),
    "netD_pixel": dict(lambda_GAN=1.0, netD="pixel"),
}
ZOO3D_STEPS = 1                # timed, after 1 warm-up (float32; 2 before
                               # spatial_joint)
ZOO3D_BF16_STEPS = 1           # timed, after 1 warm-up (bfloat16)
# the card-vs-CPU check at joint3d's narrow width and bars: 32^3, but a
# unet needs a side of 2^num_downs, so unet_128 is held at 128^3, its
# smallest cube; unet_256 is the same module with one more level (and
# 256^3 on the CPU), so unet_128's check stands for it; strided_conv at
# 16^3 (the narrow netR's smallest cube), as at 32^3 the narrow model's
# tap 0 (38^3, no downsampling) has 36^3 = 46,656 locations, 8.7 GB of
# logits an NCE call
ZOO3D_NARROW_CROP = {"netG_unet_128": 128, "netF_strided_conv": 16}
ZOO3D_NARROW_SKIP = {"netG_unet_256": "netG_unet_128"}


def phase_zoo3d(seed, smi, register_ms, train_ms):
    """Every ZOO3D_RUNS choice in the 3-D joint model at full width
    (joint3d_full: float32, 1 + ZOO3D_STEPS steps, the flow head fitted to
    JOINT3D_FIELD; bfloat16, 1 + ZOO3D_BF16_STEPS steps, BF16_3D_FIELD),
    then the narrow card-vs-CPU checks in float32 and bf16
    (joint3d_narrow; unet_256 stands on unet_128's); a line a run beside
    phase joint3d's float32 times, then a summary line with the launches
    summed over the runs."""
    totals = {k: dict(ZERO) for k in ("zoo3d_register", "zoo3d_train",
                                      "bf16_zoo3d_register",
                                      "bf16_zoo3d_train")}
    summary = {}
    for name, change in ZOO3D_RUNS.items():
        t0 = time.perf_counter()
        cfg = RegistrationConfig(**dict(JOINT3D, **change))
        pairs = joint3d_pairs(1 + ZOO3D_STEPS, cfg.crop_size, seed + 10,
                              DEVICE)
        f32 = joint3d_full(f"zoo3d {name}", cfg, seed, pairs, ZOO3D_STEPS,
                           JOINT3D_FIELD)
        low = joint3d_full(f"zoo3d {name} (bf16)", RegistrationConfig(
            **dict(JOINT3D, **change, **BF16)), seed, pairs,
                           ZOO3D_BF16_STEPS, BF16_3D_FIELD)
        del pairs
        torch.cuda.empty_cache()
        if name in ZOO3D_NARROW_SKIP:
            narrow = {"held_by": ZOO3D_NARROW_SKIP[name]}
            narrow_bf16 = dict(narrow)
        else:
            narrow = joint3d_narrow(seed, False, name, change)
            narrow_bf16 = joint3d_narrow(seed, True, name, change)
        r = {"run": name, "crop": cfg.crop_size,
             "change": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in change.items()},
             "float32": f32, "bfloat16": low,
             "narrow_card_vs_cpu": narrow,
             "narrow_card_vs_cpu_bf16": narrow_bf16,
             "wall_s": time.perf_counter() - t0}
        emit({"phase": "zoo3d", **r, "joint3d_register_ms_b1": register_ms,
              "joint3d_ms_per_step_b1": train_ms, "card": smi})
        for path, got in (("zoo3d_register", f32["register_launches"]),
                          ("zoo3d_train", f32["step_launches"]),
                          ("bf16_zoo3d_register", low["register_launches"]),
                          ("bf16_zoo3d_train", low["step_launches"])):
            for k, v in got.items():
                totals[path][k] += v
        summary[name] = {f"{dt}_{k}": part[k] for dt, part in
                         (("f32", f32), ("bf16", low))
                         for k in ("register_ms_b1", "ms_per_step_b1",
                                   "peak_mem_gb_register", "peak_mem_gb_b1")}
    emit({"phase": "zoo3d", "runs": summary,
          "joint3d_register_ms_b1": register_ms,
          "joint3d_ms_per_step_b1": train_ms, **totals, "card": smi})
    return totals


# ------------------------------------------------- data parallelism
# the card's machine has one card: two ranks share it over gloo (each its
# own process and CUDA context, taking turns on the card), and one rank
# drives the NCCL path alone; NCCL across cards is not run here
DP_DEVICES = ["cuda:0", "cuda:0"]
DP_NCCL_DEVICES = ["cuda:0"]
DP3D_CFG = {}                # fields beside VxmConfig()'s (none on the card)
DP_BATCH = 4                 # the 2-D global batch: 2 a rank
DP3D_BATCH = 2               # the 3-D global batch: 1 a rank
DP_STEPS = 1 + TRAIN_STEPS   # the compared step, then the timed ones
DP_LIMIT = 600.0             # seconds a launch may take
DP_COLLECTIVE_S = 300.0      # a collective waiting longer fails its rank
DP_CLI_FLAGS = ["--batch_size", "2", "--max_dataset_size", "4",
                "--n_epochs", "1", "--n_epochs_decay", "0",
                "--save_epoch_freq", "1", "--print_freq", "2",
                "--display_freq", "4", "--jac_freq", "4"]


def dp_launch(fn, devices, *args):
    return launch(fn, devices, args=args, timeout=DP_LIMIT,
                  collective_timeout=DP_COLLECTIVE_S)


def dp_ranks_agree(reports, per_step, what):
    """Every rank's parameters and Adam state bit-equal after each step,
    and each rank's launches ``per_step`` at every step; the launches
    summed over the ranks and steps."""
    for r in reports[1:]:
        for i, (x, y) in enumerate(zip(reports[0]["checksums"],
                                       r["checksums"])):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: rank {r['rank']} differs "
                                     f"from rank 0 after step {i}")
    for r in reports:
        for i, got in enumerate(r["launches"]):
            check_launches(f"{what}, rank {r['rank']} step {i}", got,
                           dict(ZERO, **per_step))
        bad = [(i, k) for i, m in enumerate(r["metrics"])
               for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: non-finite metrics {bad}")
    return add_counts(*((1, x) for r in reports for x in r["launches"]))


def dp_vs_single(rank0, single, lr, what, per_tensor=False):
    """The ranks' first step against one process's on the whole batch:
    metrics within PATH_TOL relative; gradients within GRAD_ENV of each
    network's (``per_tensor``: each tensor's) max |g|; after Adam, only
    first-step sign flips (|dp| <= 2.05 lr at gradients inside that band)
    and > 99% of components within 1e-5."""
    metric_errs = rel_errs(rank0["metrics"][0], single["metrics"][0],
                           PATH_TOL, what)
    grad_errs, total, mismatched = {}, 0, 0
    for net, ref in single["grads"].items():
        scales = {k: float(g.abs().max()) for k, g in ref.items()}
        net_scale = max(scales.values())
        worst = 0.0
        for k, g in ref.items():
            scale = max(scales[k] if per_tensor else net_scale, 1e-30)
            err = float((rank0["grads"][net][k] - g).abs().max()) / scale
            worst = max(worst, err)
            if not err <= GRAD_ENV:
                raise AssertionError(f"{what} {net}.{k}: gradient off by "
                                     f"{err} of max |g| > {GRAD_ENV}")
            p, q = rank0["params"][net][k], single["params"][net][k]
            mism = ~torch.isclose(p, q, atol=1e-5, rtol=1e-4)
            total += p.numel()
            mismatched += int(mism.sum())
            if mism.any() and not (
                    float((p - q)[mism].abs().max()) <= 2.05 * lr
                    and float(g[mism].abs().max()) <= GRAD_ENV * scale):
                raise AssertionError(f"{what} {net}.{k}: parameters differ "
                                     f"past a first-step sign flip")
        grad_errs[net] = worst
    if not mismatched < 0.01 * total:
        raise AssertionError(f"{what}: {mismatched} of {total} parameters "
                             f"differ past 1e-5")
    return metric_errs, grad_errs, mismatched / total


def step_ms(report):
    """Median host ms a step after the first."""
    return statistics.median(report["ms"][1:])


def gb(nbytes):
    """Bytes in GB (None off the card)."""
    return None if nbytes is None else nbytes / 1e9


def phase_dp(seed, smi):
    """The 2-D step at full width over 2 ranks on the card (gloo), global
    B=4, against one process's B=4 step; then FastCUT and lambda_GAN 1."""
    cfg = option_cfg({})
    pairs = make_pairs(DP_STEPS, DP_BATCH, cfg.crop_size, seed + 30, "cpu")
    job = dict(cfg=dict(WIDTH), seed=seed, flow_gain=FLOW_GAIN,
               batches=[(a, b) for a, b, _ in pairs], lr=cfg.lr,
               patch_seed=seed)
    single = checks.registration_steps(None, dict(job, device=DEVICE))
    torch.cuda.empty_cache()
    dp_ranks_agree([single], STEP_LAUNCHES, "dp one process")
    one = dict(job, batches=job["batches"][:1], snapshot=None)
    cases = [("cut", "registration_steps", {"job": job}),
             ("fastcut", "registration_steps",
              {"job": dict(one, cfg=dict(WIDTH, **FASTCUT))}),
             ("gan", "registration_steps",
              {"job": dict(one, cfg=dict(WIDTH, **GAN))})]
    out = dp_launch(checks.run_cases, DP_DEVICES, cases)
    reports = {name: [r[name] for r in out] for name, _, _ in cases}
    launches = {f"dp{'' if name == 'cut' else '_' + name}":
                dp_ranks_agree(reps, STEP_LAUNCHES, f"dp {name}")
                for name, reps in reports.items()}
    cut = reports["cut"]
    metric_errs, grad_errs, mism = dp_vs_single(cut[0], single, cfg.lr,
                                                "dp")
    emit({"phase": "dp", "config": "RegistrationConfig() defaults",
          "ranks": len(DP_DEVICES), "devices": DP_DEVICES,
          "backend": backend_for(DP_DEVICES), "global_batch": DP_BATCH,
          "steps": len(job["batches"]), "launches": launches,
          "launches_per_rank_step": STEP_LAUNCHES,
          "vs_one_process_rel": metric_errs,
          "grad_vs_one_process": grad_errs,
          "params_past_1e-5": mism,
          "fastcut_metrics": reports["fastcut"][0]["metrics"][0],
          "gan_metrics": reports["gan"][0]["metrics"][0],
          "ms_per_step": step_ms(cut[0]), "step_ms": cut[0]["ms"],
          "one_process_ms_per_step_b4": step_ms(single),
          "one_process_step_ms_b4": single["ms"],
          "peak_mem_gb_by_rank": [gb(r["peak_bytes"]) for r in cut],
          "one_process_peak_mem_gb_b4": gb(single["peak_bytes"]),
          "card": smi})
    return launches


def grad_spread(x, y):
    """max |x - y| over each network's gradients, over its max |g|."""
    return {net: max(float((x["grads"][net][k] - g).abs().max())
                     for k, g in ref.items())
            / max(float(g.abs().max()) for g in ref.values())
            for net, ref in y["grads"].items()}


def phase_dp_nccl(seed, smi):
    """One rank in an NCCL group on the card, B=2, 2 steps: the step's
    all-reduce over one rank gives back every gradient bit for bit; the
    first step's metrics equal one process's bit for bit, its gradients
    and parameters within phase dp's bars (the plain step is not bitwise
    reproducible on the card: two runs of it are measured beside); the
    second step timed."""
    cfg = option_cfg({})
    (a, b, _), = make_pairs(1, 2, cfg.crop_size, seed + 32, "cpu")
    job = dict(cfg=dict(WIDTH), seed=seed, flow_gain=FLOW_GAIN,
               batches=[(a, b)] * 2, lr=cfg.lr, patch_seed=seed)
    single = checks.registration_steps(None, dict(job, device=DEVICE))
    again = checks.registration_steps(None, dict(job, device=DEVICE))
    torch.cuda.empty_cache()
    out, = dp_launch(checks.run_cases, DP_NCCL_DEVICES,
                     [("steps", "registration_steps", {"job": job}),
                      ("exact", "reduce_is_exact", {"job": job})])
    rank = out["steps"]
    launches = dp_ranks_agree([rank], STEP_LAUNCHES, "dp_nccl")
    if not out["exact"]["exact"]:
        raise AssertionError("dp_nccl: the all-reduce over one NCCL rank "
                             "changed a gradient")
    if rank["metrics"][0] != single["metrics"][0]:
        raise AssertionError(f"dp_nccl: metrics {rank['metrics'][0]} "
                             f"differ from one process's "
                             f"{single['metrics'][0]}")
    _, grad_errs, mism = dp_vs_single(rank, single, cfg.lr, "dp_nccl")
    emit({"phase": "dp_nccl", "config": "RegistrationConfig() defaults",
          "ranks": len(DP_NCCL_DEVICES),
          "backend": backend_for(DP_NCCL_DEVICES),
          "batch": 2, "launches": launches,
          "reduce_bit_exact": out["exact"],
          "metrics_bit_equal": True, "metrics": rank["metrics"][0],
          "grad_vs_one_process": grad_errs,
          "grad_one_process_run_to_run": grad_spread(again, single),
          "params_past_1e-5": mism, "step_ms": rank["ms"],
          "one_process_step_ms": single["ms"],
          "nccl_across_cards": "not run: one card", "card": smi})
    return launches


def phase_dp3d(seed, smi):
    """VxmConfig() at 160^3 over 2 ranks on the card (gloo), B=1 a rank,
    against one process's B=2 step."""
    cfg = VxmConfig(**DP3D_CFG)
    S = cfg.vol_size
    pairs = make_volume_pairs(DP3D_BATCH, S, seed + 31, DEVICE)
    A, B = (torch.cat([p[i] for p in pairs]).cpu() for i in (0, 1))
    del pairs
    job = dict(cfg=dict(DP3D_CFG), seed=seed, flow_gain=FLOW_GAIN,
               batches=[(A, B)] * DP_STEPS)
    single = checks.vxm_steps(None, dict(job, device=DEVICE))
    torch.cuda.empty_cache()
    dp_ranks_agree([single], STEP3D, "dp3d one process")
    reports = dp_launch(checks.vxm_steps, DP_DEVICES, job)
    launches = dp_ranks_agree(reports, STEP3D, "dp3d")
    metric_errs, grad_errs, mism = dp_vs_single(
        reports[0], single, cfg.lr, "dp3d", per_tensor=True)
    emit({"phase": "dp3d", "config": "VxmConfig() defaults", "size": S,
          "ranks": len(DP_DEVICES), "backend": backend_for(DP_DEVICES),
          "global_batch": DP3D_BATCH, "steps": DP_STEPS,
          "launches": launches, "launches_per_rank_step": STEP3D,
          "vs_one_process_rel": metric_errs,
          "grad_vs_one_process": grad_errs, "params_past_1e-5": mism,
          "ms_per_step": step_ms(reports[0]), "step_ms": reports[0]["ms"],
          "one_process_ms_per_step_b2": step_ms(single),
          "one_process_step_ms_b2": single["ms"],
          "peak_mem_gb_by_rank": [gb(r["peak_bytes"]) for r in reports],
          "one_process_peak_mem_gb_b2": gb(single["peak_bytes"]),
          "card": smi})
    return launches


# ------------------------------------------------- the spatial axis
# VxmConfig() at 160^3 split along D over ranks sharing the card (gloo):
# (n_data, n_spatial) = (1, 2) at B=1 and (2, 2) at global B=2, each
# against one process on the whole batch
# (n_data, n_spatial): 1 x 4 gathers netR's fourth encoder level (10
# planes do not split over 4)
SPATIAL_MESHES = [(1, 2), (2, 2), (1, 4)]
SPATIAL3D_CFG = {}           # fields beside VxmConfig()'s (none on the card)
SPATIAL_STEPS = 2            # both compared, the second timed (a third
                             # timed before spatial_options)
SPATIAL_REG_REPS = 1         # register calls a rank (3 before
                             # spatial_options)
SPATIAL_TOL = 1e-5           # register max-abs, the steps' metrics relative
# the slab kernels: B3 and B4 on the half volumes from planes SLAB_Z0 of a
# 160^3 source, against the whole-volume launches' rows (bit for bit)
SLAB_SHAPE = (1, 1, 160, 160, 160)
SLAB_Z0 = (0, 80)
SLAB_FLOW_PX = 2.0


def slab_grid3d(flow, z0, D):
    """grid_sample's normalised (x, y, z) grid for a slab's pixel flow:
    its planes from global plane ``z0`` of a volume of ``D`` planes."""
    d, H, W = flow.shape[2:]
    locs = identity_grid((d, H, W), device=flow.device, z0=z0)[None] + flow
    return torch.stack([2 * (locs[:, 2] / (W - 1) - 0.5),
                        2 * (locs[:, 1] / (H - 1) - 0.5),
                        2 * (locs[:, 0] / (D - 1) - 0.5)], dim=-1)


def phase_slab_kernels(seed):
    """B3 and B4 on slabs: the output and dflow of planes [z0, z0 + D/2)
    of a (1, 1, 160^3) source under a field of about +-2 voxels, equal bit
    for bit to the whole-volume launches' rows, and within KERNEL_TOL of
    their plain versions with ``z0``; each launch timed (CUDA events,
    device us) beside its bound, its plain version and the library's call
    on the slab."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 34)
    B, C, D, H, W = SLAB_SHAPE
    src = torch.randn(SLAB_SHAPE, generator=gen, device=dev)
    flow = smooth_field3d((B, 3, D, H, W), SLAB_FLOW_PX, gen, dev)
    g = torch.randn(SLAB_SHAPE, generator=gen, device=dev)
    whole_out = warp_cuda.warp3d_cuda(src, flow)
    whole_dflow = warp_cuda.warp3d_bwd_dflow_cuda(src, flow, g)
    d = D // 2
    rows = []
    for z0 in SLAB_Z0:
        f = flow[:, :, z0:z0 + d].contiguous()
        gs = g[:, :, z0:z0 + d].contiguous()
        calls = {FWD3D: lambda: warp_cuda.warp3d_cuda(src, f, z0),
                 DFLOW3D: lambda: warp_cuda.warp3d_bwd_dflow_cuda(
                     src, f, gs, z0)}
        plains = {FWD3D: lambda: warp(src, f, impl="torch", z0=z0),
                  DFLOW3D: lambda: warp_bwd_plain(src, f, gs, need_dsrc=False,
                                                  z0=z0)[1]}
        wholes = {FWD3D: whole_out, DFLOW3D: whole_dflow}
        grid = slab_grid3d(f, z0, D)
        libs = {FWD3D: lambda: F.grid_sample(src, grid, mode="bilinear",
                                             padding_mode="zeros",
                                             align_corners=True),
                DFLOW3D: lambda: torch.ops.aten.grid_sampler_3d_backward(
                    gs, src, grid, 0, 0, True, [False, True])}
        for k, call in calls.items():
            out = call()
            bound_ms, bound_by = warp3d_bound(k, B, C, d * H * W, False)
            row = {"kernel": k, "shape": [B, C, d, H, W], "src_depth": D,
                   "z0": z0, "flow_max_vox": float(f.abs().max()),
                   "vs_whole_max_abs": float(
                       (out - wholes[k][:, :, z0:z0 + d]).abs().max()),
                   "max_abs_err": float((out - plains[k]()).abs().max()),
                   "tol": KERNEL_TOL, "ms": time_ms(call, reps=20),
                   "device_us_per_launch": device_us(call, k),
                   "plain_ms": time_ms(plains[k], reps=3, warmup=1),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": time_ms(libs[k], reps=20)}
            emit({"phase": "spatial3d", "slab_kernel": row})
            if row["vs_whole_max_abs"] != 0.0:
                raise AssertionError(f"{k} on the slab from plane {z0} "
                                     f"differs from the whole volume's rows: "
                                     f"{row['vs_whole_max_abs']}")
            if not row["max_abs_err"] <= KERNEL_TOL:
                raise AssertionError(f"{k} on the slab from plane {z0} "
                                     f"disagrees with its plain version: "
                                     f"{row['max_abs_err']} > {KERNEL_TOL}")
            rows.append(row)
    del src, flow, g, whole_out, whole_dflow
    torch.cuda.empty_cache()
    return rows


def slabs_together(reports, i):
    """The ranks' slabs of ``register``'s output i, put back together:
    along D in spatial order, the data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reports)
    return torch.cat([
        torch.cat([r["register"][i] for r in sorted(
            reports, key=lambda q: q["spatial_rank"])
                   if r["data_rank"] == d], dim=2) for d in range(n_data)])


def phase_spatial3d(seed, smi):
    """VxmConfig() at 160^3 split along D (JAX's spatial mesh axis) over 2
    ranks (n_spatial 2, B=1) and 4 ranks (2 x 2, global B=2; 1 x 4, B=1,
    netR's fourth level gathered) sharing the card over gloo, in one
    launch of 4 ranks, each against one process on the whole batch:
    register
    (y_source, pos_flow) max-abs <= SPATIAL_TOL, the metrics of 2 steps
    within SPATIAL_TOL relative, netR's gradients within GRAD_ENV of each
    tensor's max |g|; a rank's launches a step and a register call exact;
    ms, peak memory and the bytes exchanged, by rank."""
    slab_rows = phase_slab_kernels(seed)
    cfg = VxmConfig(**SPATIAL3D_CFG)
    S = cfg.vol_size
    n_items = max(n for n, _ in SPATIAL_MESHES)
    pairs = make_volume_pairs(n_items, S, seed + 35, DEVICE)
    A, B = (torch.cat([p[i] for p in pairs]).cpu() for i in (0, 1))
    del pairs
    totals = {"spatial3d_register": [], "spatial3d_train": []}
    jobs, singles, one_process_s = {}, {}, {}
    for n_data, n_spatial in SPATIAL_MESHES:
        name = f"{n_data}x{n_spatial}"
        batch = (A[:n_data], B[:n_data])
        jobs[name] = dict(cfg=dict(SPATIAL3D_CFG), seed=seed,
                          flow_gain=FLOW_GAIN,
                          batches=[batch] * SPATIAL_STEPS, register=batch,
                          reg_reps=SPATIAL_REG_REPS, n_data=n_data,
                          n_spatial=n_spatial)
        t0 = time.perf_counter()
        singles[name] = checks.vxm_spatial_steps(
            None, dict(jobs[name], device=DEVICE))
        torch.cuda.empty_cache()
        one_process_s[name] = time.perf_counter() - t0
        dp_ranks_agree([singles[name]], STEP3D,
                       f"spatial3d {name} one process")
    # one launch of the largest mesh's ranks: each smaller mesh takes its
    # first ranks (JAX's make_mesh over the first devices), the rest wait
    t0 = time.perf_counter()
    ranks = dp_launch(checks.run_cases, [DP_DEVICES[0]] * max(
        n * s for n, s in SPATIAL_MESHES), [
            (name, "vxm_spatial_steps", {"job": job})
            for name, job in jobs.items()])
    launch_s = time.perf_counter() - t0
    meshes = {}
    for n_data, n_spatial in SPATIAL_MESHES:
        name = f"{n_data}x{n_spatial}"
        single = singles.pop(name)
        reports = [r[name] for r in ranks if r[name].get("in_mesh", True)]
        if len(reports) != n_data * n_spatial:
            raise AssertionError(f"spatial3d {name}: {len(reports)} ranks "
                                 f"reported, not {n_data * n_spatial}")
        totals["spatial3d_train"].append(dp_ranks_agree(
            reports, STEP3D, f"spatial3d {name}"))
        for r in reports + [single]:
            check_launches(f"spatial3d {name} register, rank "
                           f"{r['rank']}", r["register_launches"],
                           dict(ZERO, **REG3D))
        totals["spatial3d_register"].append(add_counts(
            *((1, r["register_launches"]) for r in reports)))
        reg_errs = [float((slabs_together(reports, i)
                           - single["register"][i]).abs().max())
                    for i in (0, 1)]
        if not max(reg_errs) <= SPATIAL_TOL:
            raise AssertionError(f"spatial3d {name}: register differs from "
                                 f"one process's by {reg_errs} > "
                                 f"{SPATIAL_TOL}")
        step_errs = [rel_errs(reports[0]["metrics"][i], single["metrics"][i],
                              SPATIAL_TOL, f"spatial3d {name} step {i}")
                     for i in range(2)]
        _, grad_errs, mism = dp_vs_single(reports[0], single, cfg.lr,
                                          f"spatial3d {name}",
                                          per_tensor=True)
        past = sum(int((~torch.isclose(p, single["params"]["R"][k],
                                       atol=1e-5, rtol=1e-4)).sum())
                   for k, p in reports[0]["params"]["R"].items())
        meshes[name] = {
            "n_data": n_data, "n_spatial": n_spatial,
            "global_batch": n_data, "ranks": n_data * n_spatial,
            "netR_gathered_from_level": check_joint_slabs(
                S, n_spatial, len(cfg.enc), cfg.int_downsize),
            "register_max_abs_vs_one_process": {
                "y_source": reg_errs[0], "pos_flow": reg_errs[1]},
            "steps_rel_vs_one_process": step_errs,
            "grad_vs_one_process": grad_errs, "params_past_1e-5": mism,
            "params_past_1e-5_count": past,
            "flow_max_vox": float(single["register"][1].abs().max()),
            "one_process_s": one_process_s[name], "launch_s": launch_s,
            "ms_per_step_by_rank": [step_ms(r) for r in reports],
            "step_ms_by_rank": [r["ms"] for r in reports],
            "register_ms_by_rank": [statistics.median(r["register_ms"])
                                    for r in reports],
            "one_process_ms_per_step": step_ms(single),
            "one_process_register_ms": statistics.median(
                single["register_ms"]),
            "peak_mem_gb_by_rank": [gb(r["peak_bytes"]) for r in reports],
            "one_process_peak_mem_gb": gb(single["peak_bytes"]),
            "bytes_sent_per_step_by_rank": [r["bytes_sent"][-1]
                                            for r in reports],
            "exchange_host_s_per_step_by_rank": [r["exchange_s"][-1]
                                                 for r in reports]}
        emit({"phase": "spatial3d", "mesh": name, **meshes[name]})
    launches = {path: add_counts(*((1, c) for c in counts))
                for path, counts in totals.items()}
    emit({"phase": "spatial3d", "config": "VxmConfig() defaults", "size": S,
          "backend": backend_for(DP_DEVICES), "steps": SPATIAL_STEPS,
          "launches": launches,
          "launches_per_rank_step": STEP3D,
          "launches_per_rank_register": REG3D, "meshes": meshes,
          "slab_kernels": slab_rows, "card": smi})
    return launches, slab_rows


# ------------------------------------------------- the joint model on slabs
# RegistrationConfig() (2-D, 256^2) and RegistrationConfig(ndims=3,
# crop_size=128) split along H / D over ranks sharing the card (gloo), in
# one launch of 4 ranks: the 2-D register on 1 x 2 and 1 x 4 meshes, then
# the 3-D register and steps on 1 x 2 (the launch's first two ranks), each
# against one process on the whole image
SJ_2D_CFG = {}               # fields beside RegistrationConfig()'s (none)
SJ_2D_MESHES = [(1, 2), (1, 4)]
SJ_3D_MESH = (1, 2)
SJ_STEPS = 2                 # both compared with one process, the second timed
# (the ranks take the second from the one process's state after the first:
# Adam's first update moves each parameter by about lr * sign(g), so a
# gradient inside float32's spread flips its parameter by 2 lr, and the
# second step's loss then parts by ~1e-4 between any two float32 runs,
# one-process runs on 1 and 2 CPU threads too; the update itself is held
# to that first-step rule)
SJ_REG_REPS = 1              # register calls a rank (2 before
                             # spatial_options)
SJ_TOL = 1e-4                # register max-abs against one process
SJ_METRIC_TOL = 1e-5         # the steps' metrics, relative
# the 2-D first step's float32 gradients, the ranks' against one process's,
# each tensor over its own max |g| (a norm-fed conv bias: its network's):
# the float32 rounding of the norm-fed convs' weight gradients reaches
# 2.29e-2 of their own max on an H100 (700 W) at 1 x 4, past GRAD_ENV; the
# network-wide bar stays GRAD_ENV, the per-tensor one in float64 GRAD_ENV
SJ_GRAD_F32_TENSOR = 5e-2
# the slab kernels: B1 on the 128-row halves of a 256^2 source under a
# +-3 px field; B5 on the 64-plane halves of a 128^3 volume under a field
# of about a voxel, against the whole-volume launch
SJ_B1_SHAPE = (1, 1, 256, 256)
SJ_B1_Y0 = (0, 128)
SJ_B1_FLOW_PX = 3.0
SJ_B2_CHANNELS = (1, 2)       # B2 on the B1 case's slabs, at these C
SJ_B5_SHAPE = (1, 1, 128, 128, 128)
SJ_B5_Z0 = (0, 64)
SJ_B5_FLOW_VOX = 1.0
SJ_REGISTER = {VF: 1, FWD: 1}
# the graft's configuration (__graft_entry__.py's _tiny_cfg): crop 64 over
# 1 x 2, netR's sixth level (1 row) gathered; register and one step
SJ_GRAFT_CFG = dict(crop_size=64, num_patches=64)
SJ_GRAFT_MESH = (1, 2)
SJ_GRAFT_STEPS = 1


def norm_fed_biases(net):
    """The names of the conv biases that an instance norm follows: their
    gradient is 0 in exact arithmetic (the norm takes the mean out), so
    what a run computes for them is rounding, which the bars measure
    against the network's max |g|, not their own."""
    from dfmir_tpu_torch.nets.layers import InstanceNorm
    from dfmir_tpu_torch.nets.munit import Conv2dBlock
    names = []
    for prefix, mod in net.named_modules():
        if isinstance(mod, Conv2dBlock) and mod.norm in ("instance", "in"):
            names.append(f"{prefix}.Conv_0.bias".lstrip("."))
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            names += [f"{prefix}.{a}.bias".lstrip(".")
                      for (a, m), (_, n) in zip(kids, kids[1:])
                      if isinstance(n, InstanceNorm)
                      and getattr(m, "bias", None) is not None]
    return set(names)


def grad_errs(got, ref, skip, what, per_tensor=True, limit=GRAD_ENV):
    """Each tensor's gradient error in ``got`` against ``ref`` ({net: {name:
    grad}}) over its own max |g| (``per_tensor``; ``skip``'s, and every
    tensor's without it, over its network's), raising past ``limit``
    (None: a report alone).  Returns the worst a network, both ways, and
    its three worst tensors by that scale."""
    out = {}
    for net, gs in ref.items():
        net_scale = max(float(g.abs().max()) for g in gs.values())
        worst_tensor = worst_net = 0.0
        by_tensor = []
        for k, g in gs.items():
            err = float((got[net][k].double() - g.double()).abs().max())
            scale = max(float(g.abs().max()) if per_tensor
                        and (net, k) not in skip else net_scale, 1e-30)
            worst_tensor = max(worst_tensor, err / scale)
            worst_net = max(worst_net, err / max(net_scale, 1e-30))
            by_tensor.append((err / scale, k, scale / max(net_scale, 1e-30)))
            if limit is not None and not err <= limit * scale:
                raise AssertionError(f"{what} {net}.{k}: gradient off by "
                                     f"{err / scale} of max |g| > {limit}")
        out[net] = {"each_tensor": worst_tensor, "network": worst_net,
                    "worst": [{"tensor": k, "err": e, "scale_of_net": r}
                              for e, k, r in sorted(by_tensor)[-3:]]}
    return out


def slab_grad_errs(rank0, single, skip, lr, what, per_tensor=True):
    """The first step's gradients against the one process's
    (``grad_errs``), and the parameters after it (``rank0["params_own"]``)
    under the first-step rule: a component past 1e-5 only where Adam's
    sign(g) flipped (|dp| <= 2.05 lr at a gradient within GRAD_ENV of its
    tensor's max |g|), < 1% of them.  Returns grad_errs' report and the
    share past 1e-5."""
    out = grad_errs(rank0["grads"], single["grads"], skip, what, per_tensor)
    total, mism = 0, 0
    for net, gs in single["grads"].items():
        net_scale = max(float(g.abs().max()) for g in gs.values())
        for k, g in gs.items():
            scale = max(net_scale if (net, k) in skip
                        else float(g.abs().max()), 1e-30)
            p, q = rank0["params_own"][net][k], single["params"][net][k]
            off = ~torch.isclose(p, q, atol=1e-5, rtol=1e-4)
            total += p.numel()
            mism += int(off.sum())
            if off.any() and not (
                    float((p - q)[off].abs().max()) <= 2.05 * lr
                    and float(g[off].abs().max()) <= GRAD_ENV * scale):
                raise AssertionError(f"{what} {net}.{k}: parameters differ "
                                     f"past a first-step sign flip")
    if not mism < 0.01 * total:
        raise AssertionError(f"{what}: {mism} of {total} parameters differ "
                             f"past 1e-5")
    return out, mism / total


@contextlib.contextmanager
def expandable_segments():
    """Spawned processes' allocator growing its segments in place rather
    than caching more of them (PYTORCH_CUDA_ALLOC_CONF), for the launches
    in the block."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf


def b2_slab_rows(channels, gen, dev):
    """B2 on the SJ_B1_Y0 slabs of a (1, channels, 256, 256) image under
    a field of about +-3 px, each in its items' fixed point of max|g[b]|
    over the whole cotangent: dflow 0.0 from the whole image's B2 rows and
    within KERNEL_TOL of its plain version; the int64 sums twice the same,
    0 from the plain slab model, and added over the slabs 0.0 (as floats)
    from the whole image's B2 dsrc.  Timed beside the whole image's B2,
    its bound (the source rows the slab's targets reach read and the whole
    source's sums written, beside the slab's flow, g and dflow) and the
    library's backward of the slab's warp of the whole source."""
    B, _, H, W = SJ_B1_SHAPE
    C = channels
    src = torch.randn((B, C, H, W), generator=gen, device=dev)
    flow = smooth_field((B, 2, H, W), SJ_B1_FLOW_PX, gen, dev)
    g = torch.randn((B, C, H, W), generator=gen, device=dev)
    whole_dsrc, whole_dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g)
    mbits = item_max_bits(g)
    h = H // len(SJ_B1_Y0)
    total, out = 0, []
    for y0 in SJ_B1_Y0:
        f = flow[:, :, y0:y0 + h].contiguous()
        gs = g[:, :, y0:y0 + h].contiguous()
        call = lambda: warp_cuda.warp2d_bwd_slab_cuda(  # noqa: E731
            src, f, gs, y0, mbits)

        def plain():
            return (warp_bwd_plain(src, f, gs, need_dsrc=False, z0=y0)[1],
                    warp2d_dsrc_fixed_plain(f, gs, y0, H, mbits, sums=True))
        sums, dflow = call()
        total = total + sums
        plain_dflow, plain_sums = plain()
        locs = identity_grid((h, W), device=dev, z0=y0)[None] + f
        grid = torch.stack([2 * (locs[:, 1] / (W - 1) - 0.5),
                            2 * (locs[:, 0] / (H - 1) - 0.5)], dim=-1)
        px, vals = B * h * W, B * C * h * W
        # the source rows the slab's targets reach (bilinear: floor(y) and
        # the row below it), read once; the whole source's int64 sums
        # written once
        ys = locs[:, 0].floor()
        reach = (int((ys.max() + 1).clamp(0, H - 1))
                 - int(ys.min().clamp(0, H - 1)) + 1)
        bound_ms, bound_by = bound(
            4 * (B * C * reach * W + 2 * px + vals + 2 * px)
            + 8 * B * C * H * W, px * 12 + vals * (14 + 10))
        row = {"kernel": BWD, "case": f"slab_y0_{y0}_c{C}",
               "shape": [B, C, h, W], "src_rows": H, "y0": y0,
               "src_rows_reached": reach,
               "flow_max_px": float(f.abs().max()),
               "dflow_vs_whole_max_abs": float(
                   (dflow - whole_dflow[:, :, y0:y0 + h]).abs().max()),
               "max_abs_err": float((dflow - plain_dflow).abs().max()),
               "tol": KERNEL_TOL,
               "bit_reproducible": torch.equal(sums, call()[0]),
               "vs_plain_slab_sums_max_abs": int(
                   (sums - plain_sums).abs().max()),
               "ms": time_ms(call), "device_us_per_launch": device_us(
                   call, BWD),
               "plain_ms": time_ms(plain, reps=3, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(
                   lambda: torch.ops.aten.grid_sampler_2d_backward(
                       gs, src, grid, 0, 0, True, [True, True])),
               "whole_ms": time_ms(
                   lambda: warp_cuda.warp2d_bwd_cuda(src, flow, g)),
               "whole_device_us_per_launch": device_us(
                   lambda: warp_cuda.warp2d_bwd_cuda(src, flow, g), BWD)}
        out.append(row)
        if not (row["dflow_vs_whole_max_abs"] == 0.0
                and row["max_abs_err"] <= KERNEL_TOL
                and row["bit_reproducible"]
                and row["vs_plain_slab_sums_max_abs"] == 0):
            raise AssertionError(
                f"B2 on the slab from row {y0} at C {C}: dflow "
                f"{row['dflow_vs_whole_max_abs']} from the whole rows, "
                f"{row['max_abs_err']} from its plain version; sums twice "
                f"the same {row['bit_reproducible']}, "
                f"{row['vs_plain_slab_sums_max_abs']} from the plain model")
    err = float((from_fixed(total, mbits.reshape(-1, 1, 1, 1), H * W)
                 - whole_dsrc).abs().max())
    for row in out:
        row["slabs_vs_whole_max_abs"] = err
        emit({"phase": "spatial_joint", "slab_kernel": row})
    if err != 0.0:
        raise AssertionError(f"B2's slab sums at C {C} differ from the whole "
                             f"image's B2 by {err}")
    return out


def phase_joint_slab_kernels(seed):
    """B1 on a slab of rows and B5 on a slab of planes, at the main path's
    shapes: B1's rows 0.0 from the whole image's and within KERNEL_TOL of
    its plain version; B5's slab sums (each in the fixed point of max|g|
    over the whole cotangent) added over the slabs 0.0 from the
    whole-volume B5, each bitwise the same over two calls and equal to the
    plain slab model; B2 on B1's slabs at C 1 and 2 (b2_slab_rows); each
    timed (CUDA events, device us) beside the whole-image launch, with its
    bound and the library's call."""
    from dfmir_tpu_torch.ops.warp import abs_max_bits
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    rows = {FWD: [], BWD: [], DSRC3D: []}
    B, C, H, W = SJ_B1_SHAPE
    src = torch.randn(SJ_B1_SHAPE, generator=gen, device=dev)
    flow = smooth_field((B, 2, H, W), SJ_B1_FLOW_PX, gen, dev)
    whole = warp_cuda.warp2d_cuda(src, flow)
    h = H // len(SJ_B1_Y0)
    lib = grid_sample_call(src, flow)
    for y0 in SJ_B1_Y0:
        f = flow[:, :, y0:y0 + h].contiguous()
        call = lambda: warp_cuda.warp2d_slab_cuda(src, f, y0)  # noqa: E731
        out = call()
        # the library's call on the slab: grid_sample of the whole source
        # at the slab's global coordinates
        locs = identity_grid((h, W), device=dev, z0=y0)[None] + f
        grid = torch.stack([2 * (locs[:, 1] / (W - 1) - 0.5),
                            2 * (locs[:, 0] / (H - 1) - 0.5)], dim=-1)
        bound_ms, bound_by = warp2d_bound(B, C, h, W)
        row = {"kernel": FWD, "case": f"slab_y0_{y0}", "shape": [B, C, h, W],
               "src_rows": H, "y0": y0, "flow_max_px": float(f.abs().max()),
               "vs_whole_max_abs": float(
                   (out - whole[:, :, y0:y0 + h]).abs().max()),
               "max_abs_err": float(
                   (out - warp(src, f, impl="torch", z0=y0)).abs().max()),
               "tol": KERNEL_TOL, "ms": time_ms(call),
               "device_us_per_launch": device_us(call, FWD),
               "plain_ms": time_ms(lambda: warp(src, f, impl="torch", z0=y0),
                                   reps=10, warmup=2),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lambda: F.grid_sample(
                   src, grid, mode="bilinear", padding_mode="zeros",
                   align_corners=True)),
               "whole_ms": time_ms(lambda: warp_cuda.warp2d_cuda(src, flow)),
               "whole_device_us_per_launch": device_us(
                   lambda: warp_cuda.warp2d_cuda(src, flow), FWD),
               "whole_library_ms": time_ms(lib)}
        emit({"phase": "spatial_joint", "slab_kernel": row})
        if row["vs_whole_max_abs"] != 0.0:
            raise AssertionError(f"B1 on the slab from row {y0} differs "
                                 f"from the whole image's rows: "
                                 f"{row['vs_whole_max_abs']}")
        if not row["max_abs_err"] <= KERNEL_TOL:
            raise AssertionError(f"B1 on the slab from row {y0} disagrees "
                                 f"with its plain version: "
                                 f"{row['max_abs_err']} > {KERNEL_TOL}")
        rows[FWD].append(row)
    del src, flow, whole
    for channels in SJ_B2_CHANNELS:
        rows[BWD] += b2_slab_rows(channels, gen, dev)

    B, C, D, H, W = SJ_B5_SHAPE
    flow = smooth_field3d((B, 3, D, H, W), SJ_B5_FLOW_VOX, gen, dev)
    g = torch.randn(SJ_B5_SHAPE, generator=gen, device=dev)
    whole = warp_cuda.warp3d_bwd_dsrc_cuda(flow, g)
    mbits = abs_max_bits(g)
    d = D // len(SJ_B5_Z0)
    total = 0
    src = torch.randn(SJ_B5_SHAPE, generator=gen, device=dev)
    lib = library3d_calls(src, flow, g)[0][DSRC3D]
    for z0 in SJ_B5_Z0:
        f = flow[:, :, z0:z0 + d].contiguous()
        gs = g[:, :, z0:z0 + d].contiguous()
        # the library's source gradient of the slab's warp of the whole
        # source, at the slab's global coordinates
        grid = slab_grid3d(f, z0, D)
        call = lambda: warp_cuda.warp3d_bwd_dsrc_slab_cuda(  # noqa: E731
            f, gs, z0, D, mbits)
        sums = call()
        total = total + sums
        plain = warp3d_dsrc_binned_plain(f, gs, z0, D, mbits, sums=True)
        vals = 3 * B * d * H * W + B * C * d * H * W
        bound_ms, bound_by = bound(4 * vals + 8 * B * C * D * H * W,
                                   B * d * H * W * FLOPS3D[DSRC3D][0]
                                   + B * C * d * H * W * FLOPS3D[DSRC3D][1])
        row = {"kernel": DSRC3D, "case": f"slab_z0_{z0}",
               "shape": [B, C, d, H, W], "src_depth": D, "z0": z0,
               "flow_max_vox": float(f.abs().max()),
               "bit_reproducible": torch.equal(sums, call()),
               "vs_plain_slab_sums_max_abs": int(
                   (sums - plain).abs().max()),
               "max_abs_err": float(
                   (from_fixed(sums, mbits, D * H * W) - from_fixed(
                       plain, mbits, D * H * W)).abs().max()),
               "ms": time_ms(call, reps=20, warmup=2),
               "device_us_per_launch": device_us(call, DSRC3D),
               "plain_ms": time_ms(lambda: warp3d_dsrc_binned_plain(
                   f, gs, z0, D, mbits, sums=True), reps=3, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(
                   lambda: torch.ops.aten.grid_sampler_3d_backward(
                       gs, src, grid, 0, 0, True, [True, False]), reps=20,
                   warmup=2),
               "whole_ms": time_ms(
                   lambda: warp_cuda.warp3d_bwd_dsrc_cuda(flow, g), reps=20,
                   warmup=2),
               "whole_device_us_per_launch": device_us(
                   lambda: warp_cuda.warp3d_bwd_dsrc_cuda(flow, g), DSRC3D),
               "whole_library_ms": time_ms(lib, reps=20, warmup=2)}
        rows[DSRC3D].append(row)
        if not (row["bit_reproducible"]
                and row["vs_plain_slab_sums_max_abs"] == 0):
            raise AssertionError(f"B5 on the slab from plane {z0}: twice "
                                 f"the same {row['bit_reproducible']}, "
                                 f"{row['vs_plain_slab_sums_max_abs']} from "
                                 f"the plain slab sums")
    err = float((from_fixed(total, mbits, D * H * W) - whole).abs().max())
    for row in rows[DSRC3D]:
        row["slabs_vs_whole_max_abs"] = err
        emit({"phase": "spatial_joint", "slab_kernel": row})
    if err != 0.0:
        raise AssertionError(f"B5's slab sums differ from the whole-volume "
                             f"B5 by {err}")
    del flow, g, src, whole, total
    torch.cuda.empty_cache()
    return rows


def slab_parts(reports, i):
    """The ranks' slabs of ``register``'s output i, put back together
    along axis 2 in spatial order, the data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reports)
    return torch.cat([
        torch.cat([r["register"][i] for r in sorted(
            reports, key=lambda q: q["spatial_rank"])
                   if r["data_rank"] == d], dim=2) for d in range(n_data)])


def phase_spatial_joint(seed, smi):
    """The joint model on slabs (JAX's spatial mesh axis): the slab kernels
    (phase_joint_slab_kernels); RegistrationConfig() at 256^2 split along
    H over 2 and 4 ranks (register and SJ_STEPS steps), the graft's
    configuration at crop 64 over 2 (register and SJ_GRAFT_STEPS, netR's
    sixth level gathered) and RegistrationConfig(ndims=3, crop_size=128)
    along D over 2 (register and SJ_STEPS steps), sharing the card over
    gloo in one launch of 4 ranks, B=1, each against one process on the
    whole image (run first, alone, in a process of its own): register's
    slabs put together (fake_B, idt_B, y_source, pos_flow) <= SJ_TOL
    max-abs; the
    steps' metrics within SJ_METRIC_TOL relative and the first step's
    gradients within GRAD_ENV of each tensor's max |g| (a norm-fed conv
    bias: its network's; at 2-D so in float64, ranks and one process, and
    in float32 within GRAD_ENV of each network's and SJ_GRAD_F32_TENSOR of
    each tensor's), replicas bit-equal; a
    rank's launches exact (a
    register 1 + 1, a 2-D step 1 + 2 and 1 + 2, a 3-D step 1 + 2 and 1 + 2
    + 1); ms, peak memory, bytes and host seconds in the exchanges, by
    rank.  Two 3-D ranks take about 33 GB of the card each, so this
    process first lets go of what earlier phases left (a collection of
    their reference cycles, then the cache)."""
    gc.collect()
    torch.cuda.empty_cache()
    slab_rows = phase_joint_slab_kernels(seed)
    cfg2 = RegistrationConfig(**SJ_2D_CFG)
    cfgg = RegistrationConfig(**SJ_GRAFT_CFG)
    cfg3 = RegistrationConfig(**JOINT3D)
    A2, B2, _ = (t.cpu() for t in make_pairs(1, 1, cfg2.crop_size,
                                               seed + 41, "cpu")[0])
    AG, BG, _ = (t.cpu() for t in make_pairs(1, 1, cfgg.crop_size,
                                               seed + 43, "cpu")[0])
    (A3, B3, _), = [tuple(t.cpu() for t in p) for p in joint3d_pairs(
        1, cfg3.crop_size, seed + 42, "cpu")]
    fit = build_model(cfg3, seed, DEVICE, gain=1.0)
    gain3 = fit_flow_head(fit, A3.to(DEVICE), B3.to(DEVICE), JOINT3D_FIELD)
    # netG's module tree is the same at 2-D and 3-D (resnet_9blocks)
    skip = {("G", k) for k in norm_fed_biases(fit.netG)}
    del fit
    torch.cuda.empty_cache()
    state = tempfile.mkdtemp(prefix="chip_smoke_sj_")
    jobs = {
        "2d": dict(cfg=dict(SJ_2D_CFG), seed=seed, flow_gain=FLOW_GAIN,
                   register=(A2, B2), reg_reps=SJ_REG_REPS,
                   batches=[(A2, B2)] * SJ_STEPS, lr=cfg2.lr),
        "graft": dict(cfg=dict(SJ_GRAFT_CFG), seed=seed, flow_gain=FLOW_GAIN,
                      register=(AG, BG), reg_reps=SJ_REG_REPS,
                      batches=[(AG, BG)] * SJ_GRAFT_STEPS, lr=cfgg.lr),
        "3d": dict(cfg=dict(JOINT3D), seed=seed, flow_gain=gain3,
                   register=(A3, B3), reg_reps=SJ_REG_REPS,
                   batches=[(A3, B3)] * SJ_STEPS, lr=cfg3.lr)}
    extents = {"2d": cfg2, "graft": cfgg, "3d": cfg3}
    step_launches = {"2d": STEP_LAUNCHES, "graft": STEP_LAUNCHES,
                     "3d": JOINT3D_STEP}
    # the one-process references in a process of their own: the whole
    # image's FFT convs reserve ~18 GB that this process, fragmented by
    # what it keeps, could not give back before the ranks need the card.
    # At 2-D the first step's gradients are held tensor by tensor in
    # float64, the ranks' against one process's: in float32 the whole
    # image's own gradients of the norm-fed convs' weights are off float64
    # by up to a tenth of their max |g| (cuDNN's algorithms at these
    # shapes), which a slab's rounding cannot be held under; float32 is
    # held network by network, as phases dp and train hold the 2-D step
    t0 = time.perf_counter()
    paths = {kind: os.path.join(state, f"{kind}_after_step_0.pt")
             for kind in jobs}
    exact_kinds = ("2d", "graft")
    ref_cases = [(kind, "one_process", {"fn": "joint_spatial_steps",
                                        "job": dict(jobs[kind], save_after=(
                                            0, paths[kind]))})
                 for kind in ("3d", "2d", "graft")]
    ref_cases += [(f"{kind}_float64", "one_process", {
        "fn": "joint_spatial_steps", "job": dict(
            jobs[kind], dtype="float64", register=None,
            batches=jobs[kind]["batches"][:1])}) for kind in exact_kinds]
    with expandable_segments():
        refs = dp_launch(checks.run_cases, [DP_DEVICES[0]], ref_cases)[0]
    singles = {kind: refs[kind] for kind in jobs}
    exact = {kind: refs[f"{kind}_float64"] for kind in exact_kinds}
    for kind, job in jobs.items():
        job["load_after"] = (0, paths[kind])
        check_launches(f"spatial_joint one process {kind} register",
                       singles[kind]["register_launches"],
                       dict(ZERO, **(REG3D if kind == "3d"
                                     else SJ_REGISTER)))
        dp_ranks_agree([singles[kind]], step_launches[kind],
                       f"spatial_joint one process {kind}")
    one_process_s = time.perf_counter() - t0
    meshes_of = [("2d", n, s_) for n, s_ in SJ_2D_MESHES] + [
        ("graft", *SJ_GRAFT_MESH), ("3d", *SJ_3D_MESH)]
    cases = [(f"{kind}_{n}x{s_}", "joint_spatial_steps",
              {"job": dict(jobs[kind], n_data=n, n_spatial=s_)})
             for kind, n, s_ in meshes_of]
    cases += [(f"{kind}_{n}x{s_}_float64", "joint_spatial_steps", {
        "job": dict(jobs[kind], dtype="float64", register=None,
                    batches=jobs[kind]["batches"][:1], load_after=None,
                    n_data=n, n_spatial=s_)})
        for kind, n, s_ in meshes_of if kind in exact_kinds]
    gc.collect()
    torch.cuda.empty_cache()
    main_gb = {"allocated": gb(torch.cuda.memory_allocated()),
               "reserved": gb(torch.cuda.memory_reserved())}
    emit({"phase": "spatial_joint", "this_process_mem_gb": main_gb})
    # two 3-D ranks fill most of the card between them
    t0 = time.perf_counter()
    try:
        with expandable_segments():
            ranks = dp_launch(checks.run_cases, [DP_DEVICES[0]] * max(
                n * s_ for _, n, s_ in meshes_of), cases)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    launch_s = time.perf_counter() - t0
    totals = {"spatial_joint_register2d": [], "spatial_joint_register3d": [],
              "spatial_joint_train2d": [], "spatial_joint_train": []}
    meshes = {}
    names = ("fake_B", "idt_B", "y_source", "pos_flow")
    for name, _, kw in cases:
        if name.endswith("_float64"):
            continue
        job = kw["job"]
        kind = name.split("_")[0]
        single = singles[kind]
        reports = [r[name] for r in ranks if r[name].get("in_mesh", True)]
        want = job["n_data"] * job["n_spatial"]
        if len(reports) != want:
            raise AssertionError(f"spatial_joint {name}: {len(reports)} "
                                 f"ranks reported, not {want}")
        reg = REG3D if kind == "3d" else SJ_REGISTER
        for r in reports:
            check_launches(f"spatial_joint {name} register, rank "
                           f"{r['rank']}", r["register_launches"],
                           dict(ZERO, **reg))
        dims = "3d" if kind == "3d" else "2d"
        totals["spatial_joint_register" + dims].append(add_counts(
            *((1, r["register_launches"]) for r in reports)))
        reg_errs = {k: float((slab_parts(reports, i)
                              - single["register"][i]).abs().max())
                    for i, k in enumerate(names)}
        if not max(reg_errs.values()) <= SJ_TOL:
            raise AssertionError(f"spatial_joint {name}: register differs "
                                 f"from one process's by {reg_errs} > "
                                 f"{SJ_TOL}")
        cfg = extents[kind]
        row = {"n_data": job["n_data"], "n_spatial": job["n_spatial"],
               "ranks": want, "extent": cfg.crop_size,
               "netR_gathered_from_level": first_whole_level(
                   cfg.crop_size, job["n_spatial"], len(cfg.vxm_enc)),
               "register_max_abs_vs_one_process": reg_errs,
               "pos_flow_max": float(single["register"][3].abs().max()),
               "register_ms_by_rank": [statistics.median(r["register_ms"])
                                       for r in reports],
               "one_process_register_ms": statistics.median(
                   single["register_ms"]),
               "register_bytes_sent_by_rank": [r["register_bytes"]
                                               for r in reports],
               "register_exchange_host_s_by_rank": [
                   r["register_exchange_s"] for r in reports],
               "register_peak_mem_gb_by_rank": [
                   gb(r["register_peak_bytes"]) for r in reports],
               "one_process_register_peak_mem_gb": gb(
                   single["register_peak_bytes"])}
        totals["spatial_joint_train" + ("" if kind == "3d" else "2d")].append(
            dp_ranks_agree(reports, step_launches[kind],
                           f"spatial_joint {name}"))
        row["steps_rel_vs_one_process"] = [
            rel_errs(reports[0]["metrics"][i], single["metrics"][i],
                     SJ_METRIC_TOL, f"spatial_joint {name} step {i}")
            for i in range(len(job["batches"]))]
        row["grad_vs_one_process"], row["params_past_1e-5"] = (
            slab_grad_errs(reports[0], single, skip, job["lr"],
                           f"spatial_joint {name}",
                           per_tensor=kind not in exact))
        if kind in exact:
            row["grad_vs_one_process_each_tensor"] = grad_errs(
                reports[0]["grads"], single["grads"], skip,
                f"spatial_joint {name} float32 per tensor",
                limit=SJ_GRAD_F32_TENSOR)
            rank0_64, = [r[f"{name}_float64"] for r in ranks
                         if r[f"{name}_float64"].get("rank") == 0]
            row["grad_float64_vs_one_process_float64"] = grad_errs(
                rank0_64["grads"], exact[kind]["grads"], skip,
                f"spatial_joint {name} float64")
            row["one_process_float32_vs_float64"] = grad_errs(
                single["grads"], exact[kind]["grads"], skip,
                f"spatial_joint {name} one process", limit=None)
        row.update(
            flow_gain=job["flow_gain"],
            step_ms_by_rank=[r["ms"] for r in reports],
            ms_per_step_by_rank=[r["ms"][-1] for r in reports],
            one_process_ms_per_step=single["ms"][-1],
            peak_mem_gb_by_rank=[gb(r["peak_bytes"]) for r in reports],
            one_process_peak_mem_gb=gb(single["peak_bytes"]),
            bytes_sent_per_step_by_rank=[r["bytes_sent"][-1]
                                         for r in reports],
            exchange_host_s_per_step_by_rank=[r["exchange_s"][-1]
                                              for r in reports])
        meshes[name] = row
        emit({"phase": "spatial_joint", "mesh": name, **row})
    launches = {path: add_counts(*((1, c) for c in counts))
                for path, counts in totals.items()}
    emit({"phase": "spatial_joint",
          "config": ["RegistrationConfig() (256^2)",
                     "RegistrationConfig(crop_size=64, num_patches=64)",
                     "RegistrationConfig(ndims=3, crop_size=128)"],
          "backend": backend_for(DP_DEVICES), "steps": SJ_STEPS,
          "launches": launches,
          "launches_per_rank_step": {"2d": STEP_LAUNCHES,
                                     "3d": JOINT3D_STEP},
          "launches_per_rank_register": {"2d": SJ_REGISTER, "3d": REG3D},
          "meshes": meshes, "one_process_s": one_process_s,
          "launch_s": launch_s, "this_process_mem_gb": main_gb,
          "card": smi})
    return launches, slab_rows


# phase spatial_options: the paper model's training options on slabs, at
# RegistrationConfig()'s full width (256^2), B=1 a data rank, each against
# one process of the port on the whole batch.  run: (the options, (n_data,
# n_spatial), FastCUT's coin or None)
SO_RUNS = {
    "bf16_1x2": (BF16, (1, 2), None),
    "fastcut_heads_1x2": (FASTCUT, (1, 2), False),
    "fastcut_tails_1x2": (FASTCUT, (1, 2), True),
    "dropout_1x2": (DROPOUT, (1, 2), None),
    "gan_1x2": (GAN, (1, 2), None),
    "no_antialias_up_1x2": (dict(no_antialias_up=True), (1, 2), None),
    "all_negatives_2x2": (dict(nce_includes_all_negatives_from_minibatch=True),
                          (2, 2), None),
    "mixed_1x4": (dict(**BF16, **FASTCUT, **DROPOUT, **GAN), (1, 4), True)}
# the 3-D joint model (JOINT3D) in bfloat16 at 128^3 (its flow head
# fitted to BF16_3D_FIELD), register and SO_STEPS steps on this mesh
SO_3D_MESH = (1, 2)
SO_STEPS = 2                 # the second from the one process's state, timed
SO_DROPOUT_SEED = 11         # the dropout masks' seed, one process and ranks
SO_NETD_REPS = 3             # netD's forward and backward alone, timed
SO_REG_REPS = 1              # register calls a rank (bfloat16 runs)
# bfloat16's gradients are rounding-bound: this run's one process runs
# twice (cuDNN's spread at one shape) and once in float32 (bfloat16's own
# distance from float32), both printed beside the ranks' distance from it
SO_AGAIN = "bf16_1x2"


def so_job(cfg, seed, gain, pair, coin, mesh_shape, register):
    """joint_spatial_steps' job for one spatial_options run."""
    n_data, n_spatial = mesh_shape
    return dict(cfg=cfg, seed=seed, flow_gain=gain,
                register=pair if register else None, reg_reps=SO_REG_REPS,
                batches=[pair] * SO_STEPS, lr=RegistrationConfig().lr,
                flip=[coin] * SO_STEPS, dropout_seed=SO_DROPOUT_SEED,
                netD_reps=SO_NETD_REPS, n_data=n_data, n_spatial=n_spatial)


def so_norm_fed_biases(cfg):
    """(net, name) of every conv bias an instance norm follows in netG and
    netD of ``cfg`` (dropout shifts a ResnetBlock's indices): the names of
    a narrow twin's (ngf, ndf 2)."""
    twin = RegistrationModel(RegistrationConfig(**dict(cfg, ngf=2, ndf=2)),
                             device="cpu")
    nets = {"G": twin.netG, "D": twin.netD}
    return {(k, name) for k, net in nets.items() if net is not None
            for name in norm_fed_biases(net)}


def so_pair(batch, size, seed):
    """A global (A, B) of ``batch`` 2-D pairs on the host."""
    pairs = [tuple(t.cpu() for t in p[:2])
             for p in make_pairs(batch, 1, size, seed, "cpu")]
    return tuple(torch.cat(x) for x in zip(*pairs))


def slab_run(what, job, single, reports, per_step, reg, register_bars,
             metric_tols=None):
    """One run of a phase on slabs (``joint_spatial_steps``' job) against
    its one process on the whole batch: ``reports`` are the launch's (a
    rank past the mesh dropped), each rank's launches ``per_step`` a step
    and ``reg`` a register call, every rank's parameters and Adam states
    bit-equal after each step; register's slabs put together within
    ``register_bars`` ({output: max-abs}); the steps' metrics SJ_METRIC_TOL
    relative (bfloat16 BF16_METRIC_TOL; with the GAN phase D, D_fake,
    D_real and G_GAN too); the float32 first step's gradients within
    GRAD_ENV of each network's and SJ_GRAD_F32_TENSOR of each tensor's max
    |g| (a norm-fed conv bias: its network's), netD's too, and the update
    under the sign-flip rule (bfloat16's printed); ms a step and netD's
    forward and backward alone, peak memory, bytes and host seconds in the
    exchanges, by rank.  ``metric_tols``: {metric: relative bar} in place
    of the float32 bar for those metrics.  Returns (its line's fields, the
    steps' launches summed over the ranks, the register calls' or
    None)."""
    bf16 = job["cfg"].get("compute_dtype") == "bfloat16"
    reports = [r for r in reports if r.get("in_mesh", True)]
    want = job["n_data"] * job["n_spatial"]
    if len(reports) != want:
        raise AssertionError(f"{what}: {len(reports)} ranks reported, not "
                             f"{want}")
    dp_ranks_agree([single], per_step, f"{what} one process")
    row = {"options": {k: v for k, v in job["cfg"].items()},
           "n_data": job["n_data"], "n_spatial": job["n_spatial"],
           "ranks": want, "flip": (job.get("flip") or [None])[0],
           "flow_gain": job["flow_gain"]}
    register = None
    if job["register"] is not None:
        check_launches(f"{what} one process register",
                       single["register_launches"], dict(ZERO, **reg))
        for r in reports:
            check_launches(f"{what} register, rank {r['rank']}",
                           r["register_launches"], dict(ZERO, **reg))
        register = add_counts(*((1, r["register_launches"])
                                for r in reports))
        errs = {k: float((slab_parts(reports, i)
                          - single["register"][i]).abs().max())
                for i, k in enumerate(register_bars)}
        bad = {k: e for k, e in errs.items() if not e <= register_bars[k]}
        if bad:
            raise AssertionError(f"{what}: register differs from one "
                                 f"process's by {bad}, past {register_bars}")
        row.update(
            register_max_abs_vs_one_process=errs,
            pos_flow_max=float(single["register"][3].abs().max()),
            register_ms_by_rank=[statistics.median(r["register_ms"])
                                 for r in reports],
            one_process_register_ms=statistics.median(
                single["register_ms"]))
    train = dp_ranks_agree(reports, per_step, what)
    tol = BF16_METRIC_TOL if bf16 else SJ_METRIC_TOL
    row["steps_rel_vs_one_process"] = [
        rel_errs(reports[0]["metrics"][i], single["metrics"][i], tol,
                 f"{what} step {i}", None if bf16 else metric_tols)
        for i in range(len(job["batches"]))]
    rank0, = [r for r in reports if r["rank"] == 0]
    skip = so_norm_fed_biases(job["cfg"])
    if bf16:
        row["grad_vs_one_process"] = grad_errs(
            rank0["grads"], single["grads"], skip, f"{what} bfloat16",
            limit=None)
    else:
        row["grad_vs_one_process"], row["params_past_1e-5"] = (
            slab_grad_errs(rank0, single, skip, job["lr"], what,
                           per_tensor=False))
        row["grad_vs_one_process_each_tensor"] = grad_errs(
            rank0["grads"], single["grads"], skip,
            f"{what} float32 per tensor", limit=SJ_GRAD_F32_TENSOR)
    if "netD_ms" in single:
        row.update(netD_ms_by_rank=[statistics.median(r["netD_ms"])
                                    for r in reports],
                   one_process_netD_ms=statistics.median(single["netD_ms"]),
                   netD_bytes_by_rank=[r["netD_bytes"] for r in reports])
    row.update(
        metrics_by_step=reports[0]["metrics"],
        step_ms_by_rank=[r["ms"] for r in reports],
        ms_per_step_by_rank=[r["ms"][-1] for r in reports],
        one_process_ms_per_step=single["ms"][-1],
        peak_mem_gb_by_rank=[gb(r["peak_bytes"]) for r in reports],
        one_process_peak_mem_gb=gb(single["peak_bytes"]),
        bytes_sent_per_step_by_rank=[r["bytes_sent"][-1] for r in reports],
        exchange_host_s_per_step_by_rank=[r["exchange_s"][-1]
                                          for r in reports])
    return row, train, register


def phase_spatial_options(seed, smi):
    """The paper model's training options on slabs (A12c's item 2.2): at
    RegistrationConfig()'s full width over 2 ranks each alone (bfloat16
    with register, FastCUT at each coin, dropout, the GAN phase with netD
    basic, no_antialias_up), all-negatives PatchNCE over 2 x 2 (global
    B=2) and bfloat16 + FastCUT + dropout + the GAN phase over 1 x 4, in
    one launch of 4 ranks sharing the card (gloo) with the 3-D joint model
    in bfloat16 at 128^3 over 1 x 2 (register and SO_STEPS steps), B=1 a
    data rank, each against one process on the whole batch run first in a
    launch of its own: register's slabs put together within BF16_BARS; the
    steps' metrics (with the GAN phase D, D_fake, D_real and G_GAN)
    SJ_METRIC_TOL relative, BF16_METRIC_TOL in bfloat16 (the second step
    from the one process's state after the first); the float32 first
    step's gradients within GRAD_ENV of each network's max |g| and
    SJ_GRAD_F32_TENSOR of each tensor's (a norm-fed conv bias: its
    network's), netD's too, and the update under the first-step sign-flip
    rule (bfloat16's printed); every rank's parameters and Adam states
    (netD's too) bit-equal after each step; a rank's launches exact (a 2-D
    step STEP_LAUNCHES with any option, the GAN's D phase none; a 3-D step
    JOINT3D_STEP; a register 1 + 1); ms a step and netD's forward and
    backward alone, peak memory, bytes and host seconds in the exchanges,
    by rank."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = RegistrationConfig(**SJ_2D_CFG)
    pair1 = so_pair(1, cfg2.crop_size, seed + 51)
    pair2 = so_pair(2, cfg2.crop_size, seed + 52)
    name3, opts3 = "bf16_3d_1x2", dict(**JOINT3D, **BF16)
    cfg3 = RegistrationConfig(**opts3)
    (A3, B3, _), = [tuple(t.cpu() for t in p) for p in joint3d_pairs(
        1, cfg3.crop_size, seed + 53, "cpu")]
    fit = build_model(cfg3, seed, DEVICE, gain=1.0)
    gain3 = fit_flow_head(fit, A3.to(DEVICE), B3.to(DEVICE), BF16_3D_FIELD)
    del fit
    gc.collect()
    torch.cuda.empty_cache()
    jobs = {}
    for name, (opts, mesh_shape, coin) in SO_RUNS.items():
        bf16 = opts.get("compute_dtype") == "bfloat16"
        jobs[name] = so_job(dict(SJ_2D_CFG, **opts), seed, BF16_GAIN if bf16
                            else FLOW_GAIN, pair2 if mesh_shape[0] > 1
                            else pair1, coin, mesh_shape, bf16)
    jobs[name3] = so_job(opts3, seed, gain3, (A3, B3), None, SO_3D_MESH,
                         True)
    state = tempfile.mkdtemp(prefix="chip_smoke_so_")
    paths = {name: os.path.join(state, f"{name}_after_step_0.pt")
             for name in jobs}
    # the one-process references first, in a launch of their own
    t0 = time.perf_counter()
    try:
        with expandable_segments():
            singles = dp_launch(checks.run_cases, [DP_DEVICES[0]], [
                (name, "one_process", {"fn": "joint_spatial_steps",
                                       "job": dict(job, save_after=(
                                           0, paths[name]))})
                for name, job in jobs.items()] + [
                (f"{SO_AGAIN}_again", "one_process", {
                    "fn": "joint_spatial_steps", "job": dict(
                        jobs[SO_AGAIN], register=None,
                        batches=jobs[SO_AGAIN]["batches"][:1])}),
                (f"{SO_AGAIN}_float32", "one_process", {
                    "fn": "joint_spatial_steps", "job": dict(
                        jobs[SO_AGAIN], register=None,
                        cfg=dict(jobs[SO_AGAIN]["cfg"],
                                 compute_dtype="float32"),
                        batches=jobs[SO_AGAIN]["batches"][:1])})])[0]
        one_process_s = time.perf_counter() - t0
        for name, job in jobs.items():
            job["load_after"] = (0, paths[name])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        # the 3-D run first: its two ranks take most of the card
        order = [name3] + list(SO_RUNS)
        with expandable_segments():
            ranks = dp_launch(checks.run_cases, [DP_DEVICES[0]] * 4, [
                (name, "joint_spatial_steps", {"job": jobs[name]})
                for name in order])
        launch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(state, ignore_errors=True)
    totals = {"spatial_options_train2d": [], "spatial_options_train3d": [],
              "spatial_options_register2d": [],
              "spatial_options_register3d": []}
    runs = {}
    for name in order:
        job, single = jobs[name], singles[name]
        dims = "3d" if name == name3 else "2d"
        what = f"spatial_options {name}"
        row, train, register = slab_run(
            what, job, single, [r[name] for r in ranks],
            JOINT3D_STEP if dims == "3d" else STEP_LAUNCHES,
            REG3D if dims == "3d" else SJ_REGISTER, BF16_BARS)
        totals[f"spatial_options_train{dims}"].append(train)
        if register is not None:
            totals[f"spatial_options_register{dims}"].append(register)
        if name == SO_AGAIN:
            skip = so_norm_fed_biases(job["cfg"])
            rank0, = [r[name] for r in ranks if r[name].get("rank") == 0]
            f32 = singles[f"{name}_float32"]["grads"]
            row.update(
                one_process_grad_run_to_run=grad_errs(
                    singles[f"{name}_again"]["grads"], single["grads"],
                    skip, f"{what} one process twice", limit=None),
                one_process_bf16_vs_float32=grad_errs(
                    single["grads"], f32, skip,
                    f"{what} one process against float32", limit=None),
                grad_vs_one_process_float32=grad_errs(
                    rank0["grads"], f32, skip, f"{what} against float32",
                    limit=None))
        runs[name] = row
        emit({"phase": "spatial_options", "run": name, **row})
    launches = {path: add_counts(*((1, c) for c in counts))
                for path, counts in totals.items()}
    emit({"phase": "spatial_options",
          "config": ["RegistrationConfig() (256^2) with each option",
                     "RegistrationConfig(ndims=3, crop_size=128, "
                     "compute_dtype='bfloat16')"],
          "backend": backend_for(DP_DEVICES), "steps": SO_STEPS,
          "launches": launches,
          "launches_per_rank_step": {"2d": STEP_LAUNCHES,
                                     "3d": JOINT3D_STEP},
          "runs": list(runs), "one_process_s": one_process_s,
          "launch_s": launch_s, "card": smi})
    return launches


# phase spatial_zoo: the 2-D-only generators on slabs (A12c item 2.2.1's
# second half), at RegistrationConfig()'s full width with the netG named
# (256^2, ngf 64), B=1 a data rank, each against one process of the port
# on the whole batch.  run: (the config's fields, (n_data, n_spatial))
SZ_CAT = dict(netG="resnet_cat", nce_layers=(0, 1, 2, 3))
SZ_SG = dict(netG="stylegan2", nce_layers=(1, 2, 3))
SZ_GAN = dict(lambda_GAN=1.0)
SZ_RUNS = {
    "resnet_cat_1x2": (SZ_CAT, (1, 2)),
    "resnet_cat_1x4": (SZ_CAT, (1, 4)),
    "stylegan2_gan_1x2": (dict(SZ_SG, **SZ_GAN, netD="stylegan2"), (1, 2)),
    "smallstylegan2_tile_1x4": (dict(SZ_SG, **SZ_GAN, netG="smallstylegan2",
                                     netD="tilestylegan2"), (1, 4)),
    "stylegan2_patch_2x2": (dict(SZ_SG, **SZ_GAN, netD="patchstylegan2"),
                            (2, 2)),
    "stylegan2_bf16_1x2": (dict(SZ_SG, **BF16), (1, 2))}
SZ_REGISTER_TOL = 1e-4       # register max-abs against one process (float32)
# the StyleGAN2 generators' float32 fields about a third of a pixel: one of
# a pixel or more samples past the image's ends, so y_source holds exact
# zeros, and from_rgb's 1x1 conv (zero bias) maps such a pixel to a zero
# tap, whose PatchNCE sample gets the L2 norm's 1/eps derivative
SZ_SG_GAIN = 1e4
# the netDs whose head is one linear unit an image (or a 64-pixel tile):
# D_fake and G_GAN square that one prediction, with no patch map to
# average float32's spread out, and G_GAN reads netD after its Adam step
# (lr * sign(g) first).  On an H100 (700 W) the one process's own second
# step, run twice from one state, moves G_GAN by 1.35e-5 relative (netD
# stylegan2), past SJ_METRIC_TOL, and the ranks part from the one process
# there by up to 8.1e-5 (G_GAN, tilestylegan2, step 0) and 3.4e-5 (D_fake,
# 0.039); netD patchstylegan2's patch map: <= 1e-6.  Those two metrics of
# these runs are held at SZ_SCALAR_D_TOL, every other at SJ_METRIC_TOL
SZ_SCALAR_NETDS = ("stylegan2", "tilestylegan2")
SZ_SCALAR_D_TOL = 3e-4


def phase_spatial_zoo(seed, smi):
    """The 2-D-only generators on slabs (A12c item 2.2.1): at
    RegistrationConfig()'s full width with netG resnet_cat (taps 0,1,2,3;
    1 x 2 and 1 x 4), stylegan2 (taps 1,2,3) with the GAN phase and netD
    stylegan2 (1 x 2) or patchstylegan2 (2 x 2, global B=2), smallstylegan2
    with netD tilestylegan2 (1 x 4), and stylegan2 in bfloat16 (1 x 2), in
    one launch of 4 ranks sharing the card (gloo), B=1 a data rank, each
    with register and SO_STEPS steps against one process on the whole
    batch run first in a launch of its own (``slab_run``): register's
    slabs put together within SZ_REGISTER_TOL max-abs (bfloat16
    BF16_BARS), the steps' metrics SJ_METRIC_TOL relative (BF16_METRIC_TOL),
    G_GAN and D_fake SZ_SCALAR_D_TOL with a scalar-head netD (beside the
    one process's own spread, each GAN run's steps run twice), the float32
    first step's gradients within GRAD_ENV of each network's and
    SJ_GRAD_F32_TENSOR of each tensor's max |g| (netD's too) and its
    update under the sign-flip rule, every rank's parameters and Adam
    states bit-equal; a rank's launches exact (a step STEP_LAUNCHES, a
    register 1 + 1); ms a step and netD's forward and backward alone, peak
    memory, bytes and host seconds in the exchanges, by rank."""
    gc.collect()
    torch.cuda.empty_cache()
    size = RegistrationConfig(**SJ_2D_CFG).crop_size
    pair1 = so_pair(1, size, seed + 61)
    pair2 = so_pair(2, size, seed + 62)
    jobs = {}
    for name, (opts, mesh_shape) in SZ_RUNS.items():
        cfg = dict(SJ_2D_CFG, **opts)
        gain = (BF16_GAIN if cfg.get("compute_dtype") == "bfloat16"
                else FLOW_GAIN if cfg["netG"] == "resnet_cat" else SZ_SG_GAIN)
        jobs[name] = so_job(cfg, seed, gain, pair2 if mesh_shape[0] > 1
                            else pair1, None, mesh_shape, True)
    state = tempfile.mkdtemp(prefix="chip_smoke_sz_")
    paths = {name: os.path.join(state, f"{name}_after_step_0.pt")
             for name in jobs}
    gan = [name for name, job in jobs.items()
           if job["cfg"].get("lambda_GAN", 0) > 0]
    t0 = time.perf_counter()
    try:
        # each GAN run's steps once more (the first from the seed, the
        # second from the saved state): the one process's own spread
        with expandable_segments():
            singles = dp_launch(checks.run_cases, [DP_DEVICES[0]], [
                (name, "one_process", {"fn": "joint_spatial_steps",
                                       "job": dict(job, save_after=(
                                           0, paths[name]))})
                for name, job in jobs.items()] + [
                (f"{name}_again", "one_process", {
                    "fn": "joint_spatial_steps", "job": dict(
                        jobs[name], register=None, netD_reps=None,
                        load_after=(0, paths[name]))}) for name in gan])[0]
        one_process_s = time.perf_counter() - t0
        for name, job in jobs.items():
            job["load_after"] = (0, paths[name])
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with expandable_segments():
            ranks = dp_launch(checks.run_cases, [DP_DEVICES[0]] * 4, [
                (name, "joint_spatial_steps", {"job": job})
                for name, job in jobs.items()])
        launch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(state, ignore_errors=True)
    train, register = [], []
    for name, job in jobs.items():
        bf16 = job["cfg"].get("compute_dtype") == "bfloat16"
        single = singles[name]
        row = {}
        if name in gan:
            # step 0 from the seed, step 1 from the saved state, again
            row["one_process_run_to_run_by_step"] = [
                {k: abs(again[k] - v) / max(abs(v), 1e-12)
                 for k, v in first.items()}
                for first, again in zip(single["metrics"],
                                        singles[f"{name}_again"]["metrics"])]
        scalar = job["cfg"].get("netD") in SZ_SCALAR_NETDS and name in gan
        fields, steps, reg = slab_run(
            f"spatial_zoo {name}", job, single, [r[name] for r in ranks],
            STEP_LAUNCHES, SJ_REGISTER,
            BF16_BARS if bf16 else dict.fromkeys(BF16_BARS, SZ_REGISTER_TOL),
            dict.fromkeys(("G_GAN", "D_fake"), SZ_SCALAR_D_TOL) if scalar
            else None)
        train.append(steps)
        register.append(reg)
        emit({"phase": "spatial_zoo", "run": name, **fields, **row})
    launches = {"spatial_zoo_train": add_counts(*((1, c) for c in train)),
                "spatial_zoo_register": add_counts(*((1, c)
                                                     for c in register))}
    emit({"phase": "spatial_zoo",
          "config": "RegistrationConfig() (256^2) with each run's netG",
          "backend": backend_for(DP_DEVICES), "steps": SO_STEPS,
          "launches": launches,
          "launches_per_rank_step": STEP_LAUNCHES,
          "launches_per_rank_register": SJ_REGISTER,
          "runs": list(jobs), "one_process_s": one_process_s,
          "launch_s": launch_s, "card": smi})
    return launches


def phase_dp_cli(seed, smi):
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    try:
        with open(os.path.join(root, "cli.log"), "w") as log:
            return dp_cli_paths(root, log, seed, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dp_cli_paths(root, log, seed, smi):
    """train.main over 2 ranks on the card (gloo) on phase cli's PNG
    pairs: 2 steps at B=2, one set of files, `latest` equal to the
    ranks' final weights."""
    data, ck_dir = os.path.join(root, "data"), os.path.join(root, "ck")
    write_cli_data(data, seed, CLI_SIZE)
    common = ["--dataroot", data, "--checkpoints_dir", ck_dir, "--seed",
              str(seed), "--name", "dp_cli", "--gpu_ids", CLI_GPU,
              *CLI_FLAGS, *DP_CLI_FLAGS]
    with contextlib.redirect_stdout(log):
        out = train_cli.main(common, devices=DP_DEVICES,
                             timeout=DP_LIMIT)
    ck = os.path.join(ck_dir, "dp_cli")
    steps = len(out["step_s"])
    want_files = sorted(
        [f"{e}_net_{n}.pth" for e in ("1", "latest") for n in "GFR"]
        + [f"{e}_optim.pth" for e in ("1", "latest")]
        + ["loss_history.jsonl", "loss_log.txt", "train_opt.txt", "web"])
    files = sorted(os.listdir(ck))
    recs = losses_of(ck)
    with open(os.path.join(ck, "loss_log.txt")) as f:
        log_text = f.read()
    # --print_freq 2 at a global batch of 2: a print every step
    if (steps != 2 or files != want_files or len(recs) != steps
            or log_text.count("(epoch: 1,") != steps
            or log_text.count("Training Loss") != 1):
        raise AssertionError(f"dp_cli: {steps} steps, files {files}, "
                             f"{len(recs)} loss records: expected 2, "
                             f"{want_files}, one print a step, once")
    want = cli_train_launches(steps, 2, 4, 2, 4)
    for r, rank in enumerate(out["ranks"]):
        check_launches(f"dp_cli rank {r}", rank["launches"], want)
    # `latest`, loaded on the card, is rank 1's final weights bit for bit
    with contextlib.redirect_stdout(log):
        opt = TrainOptions(common + ["--continue_train"]).parse()
    fresh = RegistrationTask(opt)
    fresh.setup(opt)
    final = out["ranks"][1]["weights"]
    unequal = [f"{n}.{k}" for n, sd in final.items()
               for k, v in sd.items()
               if not torch.equal(fresh._nets()[n].state_dict()[k].cpu(), v)]
    if unequal:
        raise AssertionError(f"dp_cli: `latest` differs from rank 1's "
                             f"weights at {unequal[:8]}")
    emit({"phase": "dp_cli", "ranks": len(DP_DEVICES),
          "backend": backend_for(DP_DEVICES),
          "flags": CLI_FLAGS + DP_CLI_FLAGS, "steps": steps,
          "files": files, "loss_records": len(recs),
          "launches_by_rank": [r["launches"] for r in out["ranks"]],
          "reload_tensors_equal": sum(len(sd) for sd in final.values()),
          "losses_last": recs[-1]["losses"],
          "step_ms": [x * 1e3 for x in out["step_s"]],
          "peak_mem_gb_by_rank": [gb(r["peak_bytes"])
                                  for r in out["ranks"]], "card": smi})
    return {"dp_cli": add_counts(*((1, r["launches"])
                                   for r in out["ranks"]))}


RECIPE_SIZE, RECIPE_TRAIN, RECIPE_TEST = 64, 24, 12
# VXM3D_RECIPE_r05.json's recipe (the JAX package's 3-D quality record):
# textured volumes, mse, lambda_smooth 0.01, lr 1e-3
RECIPE_FLAGS = ["--model", "vxm", "--dataset_mode", "volume",
                "--image_loss", "mse", "--lambda_smooth", "0.01",
                "--lr", "1e-3"]


def phase_recipe3d(seed, smi, epochs):
    """Train the recipe through the command line on the card for
    ``epochs`` epochs (half at the initial rate, half decaying), then
    score `latest` with evaluate --ndims 3 on the held-out pairs."""
    root = tempfile.mkdtemp(prefix="chip_smoke_recipe3d_")
    try:
        data, ck_dir = os.path.join(root, "data"), os.path.join(root, "ck")
        t0 = time.perf_counter()
        write_volumes(data, RECIPE_TRAIN, RECIPE_TEST, RECIPE_SIZE, seed)
        write_s = time.perf_counter() - t0
        shape = volume_args(data, "recipe3d", ck_dir, RECIPE_SIZE, [])
        t0 = time.perf_counter()
        with open(os.path.join(root, "train.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            trained = train_cli.main(
                RECIPE_FLAGS + shape + [
                    "--gpu_ids", CLI_GPU, "--seed", str(seed),
                    "--print_freq", str(RECIPE_TRAIN),   # once an epoch
                    "--save_epoch_freq", str(epochs),    # `latest` at the end
                    "--n_epochs", str(epochs - epochs // 2),
                    "--n_epochs_decay", str(epochs // 2)])
        train_s = time.perf_counter() - t0
        steps, step_s = trained["model"].step, trained["step_s"]
        recs = losses_of(os.path.join(ck_dir, "recipe3d"))
        del trained
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with open(os.path.join(root, "eval.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            scored = eval_cli.main(["--ndims", "3", "--gpu_ids", CLI_GPU,
                                    "--num_test", str(RECIPE_TEST), *shape])
        eval_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = scored["summary"]
    finite_summary(summary, RECIPE_TEST, "recipe3d evaluate")
    gains = [r["dice_after"] - r["dice_before"] for r in scored["records"]]
    emit({"phase": "recipe3d", "recipe": "VXM3D_RECIPE_r05.json",
          "flags": RECIPE_FLAGS, "vol_size": RECIPE_SIZE,
          "pairs": {"train": RECIPE_TRAIN, "test": RECIPE_TEST},
          "epochs": epochs, "n_epochs": epochs - epochs // 2,
          "n_epochs_decay": epochs // 2, "steps": steps,
          "data_write_s": write_s, "train_wall_s": train_s,
          "ms_per_step": statistics.median(step_s) * 1e3,
          "step_ms_max": max(step_s) * 1e3,
          "wall_ms_per_step": train_s * 1e3 / max(steps, 1),
          "eval_wall_s": eval_s,
          "losses": [recs[i]["losses"] for i in
                     sorted({0, len(recs) // 4, len(recs) // 2,
                             3 * len(recs) // 4, len(recs) - 1})],
          "summary": summary, "pairs_regressing": sum(g < 0 for g in gains),
          "min_pair_dice_gain": min(gains),
          "evaluate_ms_per_pair": statistics.median(scored["pair_s"]) * 1e3,
          "card": smi})
    if not summary["mean_dice_after"] > summary["mean_dice_before"]:
        raise AssertionError(f"recipe3d: Dice did not rise: {summary}")
    return summary


# ------------------------------------------------------------ phase 8
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")


def busy_us(prof):
    """Time the card ran at least one kernel: the union of the kernels'
    intervals (kernels that overlap count once), in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, lo, hi = 0.0, None, None
    for s0, s1 in spans:
        if hi is None or s0 > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s0, s1
        else:
            hi = max(hi, s1)
    return busy + (0.0 if hi is None else hi - lo)


def trace(call, calls, warmup=2):
    """Device time by kernel and by conv op over ``calls`` calls (after
    ``warmup`` warm-up calls), with the span from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / calls
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / calls
    busy_ms = busy_us(prof) / 1e3 / calls
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in CONV_OPS]
    top_convs = sorted(convs, key=lambda e: -e.device_time_total)[:6]
    warps = {}
    for name in warp_cuda.LAUNCHES:
        hits = [e for e in kernels if name in e.key]
        if not hits:
            continue
        warps[name] = {
            "device_us_per_launch": [e.device_time_total / e.count
                                     for e in hits],
            "launches_per_call": [e.count / calls for e in hits],
            "ms_per_call": sum(e.device_time_total for e in hits) / 1e3
            / calls}
    return {"calls": calls, "device_ms_per_call": device_ms,
            "busy_ms_per_call": busy_ms, "span_ms_per_call": span_ms,
            "device_idle_share": 1 - busy_ms / span_ms,
            "warp_kernels": warps,
            "warp_share_of_device": sum(w["ms_per_call"]
                                        for w in warps.values()) / device_ms,
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_call": e.device_time_total / 1e3 / calls,
                             "launches_per_call": e.count / calls}
                            for e in top],
            "top_convs": [{"op": e.key,
                           "input_shapes": str(e.input_shapes)[:160],
                           "ms_per_call": e.device_time_total / 1e3 / calls}
                          for e in top_convs]}


def phase_profile(model, seed, ms_b1):
    """Register calls at B=1: device time by kernel and by conv shape, the
    split between netG and netR by CUDA events, and the same calls with
    cuDNN's autotuner on (torch.backends.cudnn.benchmark), restored after."""
    (a, b, lab), = make_pairs(1, 1, model.cfg.crop_size, seed, DEVICE)
    call = lambda: infer.register_pair_outputs(model, a, b, lab)  # noqa: E731
    traced = trace(call, 3)
    with torch.no_grad():
        ab = torch.cat([a, b], dim=0)
        netG_ms = time_ms(lambda: model.netG(ab), reps=10, warmup=2)
        netR_ms = time_ms(lambda: model.netR(a, b, registration=True),
                          reps=10, warmup=2)
    torch.backends.cudnn.benchmark = True
    try:
        tuned_ms = time_ms(call, reps=20, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = False
    emit({"phase": "profile", "path": "register", **traced,
          "ms_per_pair_b1": ms_b1, "netG_ms": netG_ms, "netR_ms": netR_ms,
          "ms_per_pair_b1_cudnn_benchmark": tuned_ms})


def phase_profile_train(model, seed, ms_b1):
    """Train steps at B=1: device time by kernel and by conv op, and the
    idle share."""
    (a, b, _), = make_pairs(1, 1, model.cfg.crop_size, seed + 5, DEVICE)
    gen = patch_gen(seed)
    traced = trace(lambda: model.train_step(a, b, model.cfg.lr,
                                            generator=gen), 2)
    emit({"phase": "profile", "path": "train", **traced,
          "ms_per_step_b1": ms_b1})


def phase_profile_vxm3d(eng, pair, ms_step):
    """3-D train steps at B=1: device time by kernel and by conv op, and the
    idle share."""
    traced = trace(lambda: eng.train_step(*pair), 2)
    emit({"phase": "profile", "path": "train3d", **traced,
          "ms_per_step_b1": ms_step})


# ------------------------------------------------- A13b's tail on the card
AUG_SHAPES = {"augment2d": (8, 1, 256, 256),       # B=8 at the paper's crop
              "augment3d": (1, 1, 160, 160, 160)}  # VxmConfig()'s volume
AUG_LAUNCHES = {2: {VF: 1, FWD: 1}, 3: {VF3: 1, FWD3D: 1}}
AUG_TOL = 1e-4
AUG_REPS = 20


def smooth_image(shape, seed):
    """A smooth image in about [-1, 1] (B, C, *spatial) and a 4-label map
    of it (0, 60, 120, 180 / 255, as test.py reads label PNGs), on the
    CPU."""
    gen = torch.Generator().manual_seed(seed)
    B, C, *spatial = shape
    low = torch.randn((B, C, *(max(n // 16, 2) for n in spatial)),
                      generator=gen)
    img = torch.tanh(1.5 * F.interpolate(
        low, size=tuple(spatial), align_corners=True,
        mode="bilinear" if len(spatial) == 2 else "trilinear"))
    lab = torch.bucketize(img, torch.tensor([-0.5, 0.0, 0.5])).float()
    return img, lab * 60 / 255


def augment_case(name, seed):
    """One augment call counted, its labels' values, the same draws on
    the card and on the CPU, ms a call and peak memory."""
    shape = AUG_SHAPES[name]
    nd, spatial = len(shape) - 2, shape[2:]
    img, lab = smooth_image(shape, seed)
    src, lab_d = img.to(DEVICE), lab.to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.synchronize()
    warp_cuda.reset_launches()
    out, lab_out, flow = augment_ops.augment(src, gen, label=lab_d)
    torch.cuda.synchronize()
    launches = dict(warp_cuda.LAUNCHES)
    check_launches(f"{name}, one call", launches,
                   dict(ZERO, **AUG_LAUNCHES[nd]))
    kept = set(lab_out.unique().tolist()) <= set(lab.unique().tolist())
    finite = bool(out.isfinite().all()) and bool(flow.isfinite().all())
    flow_max = float(flow.abs().max())
    draws = augment_ops.draw_deformation(gen, shape[0], spatial)
    card = augment_ops.deform(
        src, augment_ops.deformation_from_draws(draws, spatial), lab_d)
    t0 = time.perf_counter()
    cpu = augment_ops.deform(img, augment_ops.deformation_from_draws(
        augment_ops.DeformationDraws(*(x.cpu() for x in draws)), spatial),
        lab)
    cpu_s = time.perf_counter() - t0
    errs = {k: float((c.cpu() - r).abs().max())
            for k, c, r in zip(("image", "label", "flow"), card, cpu)}
    label_mismatch = float((card[1].cpu() != cpu[1]).float().mean())
    ms = time_ms(lambda: augment_ops.augment(src, gen, label=lab_d),
                 reps=AUG_REPS, warmup=3)
    ms_image = time_ms(lambda: augment_ops.augment(src, gen),
                       reps=AUG_REPS, warmup=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    augment_ops.augment(src, gen, label=lab_d)
    torch.cuda.synchronize()
    row = {"phase": "augment", "case": name, "shape": list(shape),
           "svf_size": list(augment_ops.svf_size(spatial)),
           "launches": launches, "labels_kept": kept, "finite": finite,
           "flow_max_px": flow_max, "card_vs_cpu_max_abs": errs,
           "label_mismatch_fraction": label_mismatch, "tol": AUG_TOL,
           "ms_per_call": ms, "ms_per_call_no_label": ms_image,
           "peak_gb": gb(torch.cuda.max_memory_allocated()),
           "cpu_s": cpu_s}
    emit(row)
    if not (kept and finite and flow_max > 1.0):
        raise AssertionError(f"{name}: labels kept {kept}, finite {finite},"
                             f" flow max {flow_max} px")
    for k in ("image", "flow"):
        if not errs[k] <= AUG_TOL:
            raise AssertionError(f"{name} {k}: card vs CPU {errs[k]} > "
                                 f"{AUG_TOL}")
    return launches


def phase_augment(seed, smi):
    """ops/augment.py at full size: 1 chain forward at the SVF's size + 1
    B1 / B3 a call, the nearest label warp the plain gather."""
    launches = {name: augment_case(name, seed + i)
                for i, name in enumerate(AUG_SHAPES)}
    emit({"phase": "augment", "launches_per_call": launches, "card": smi})
    return launches


AFFINE_CASES = {"affine2d": ((8, 1, 256, 256), "NCC"),
                "affine3d": ((1, 1, 160, 160, 160), "L2")}
AFFINE_STEPS = 5
# the loss falls over 8 steps at 1e-4 in both cases; at 1e-3 the 3-D step
# overshoots (fc_0 takes 256,000 inputs at 160^3)
AFFINE_LR = 1e-4
# the gradients' card-vs-CPU check takes NCC's conv method: through the
# summed-area tables the float32 gradient on the 2-D pair is far from
# float64's on the CPU itself (the row's ncc_f32_vs_f64_cpu), past the 1e-2
# bar for any float32 program; the steps take get_loss's default
AFFINE_CHECK_KW = {"NCC": {"method": "conv"}}


def affine_pair(shape, seed):
    """(moving, fixed) on the CPU: a smooth image with a texture (no
    window of NCC without variance, where its gradient is ill-conditioned)
    and the same warped by a known small random affine."""
    fixed, _ = smooth_image(shape, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    fixed = torch.tanh(fixed + 0.25 * torch.randn(shape, generator=gen))
    matrix = augment_ops.random_affine_matrix(
        gen, shape[0], shape[2:], max_rotation=4.0, max_scaling=0.04,
        max_translation=3.0)
    return affine_warp(fixed, matrix), fixed


def affine_net(shape, seed, device, state=None):
    net = AffineRegistration(shape[2:], ndims=len(shape) - 2,
                             generator=torch.Generator().manual_seed(seed))
    if state is not None:
        net.load_state_dict(state)
    return net.to(device)


def affine_grads(net, loss_fn, moving, fixed):
    """The loss and each parameter's gradient (on the CPU) at ``net``'s
    weights."""
    net.zero_grad()
    warped, matrix, flow = net(moving, fixed)
    loss = loss_fn(warped, fixed)
    loss.backward()
    return (float(loss.detach()),
            [p.grad.detach().cpu().clone() for p in net.parameters()],
            (warped, matrix, flow))


def ncc_f32_vs_f64(shape, seed, pair, state):
    """The first step's gradients through each of NCC's methods in float32
    against float64, on the CPU: max error / max |g|."""
    out = {}
    for method in ("integral", "conv"):
        grads = [affine_grads(affine_net(shape, seed, "cpu", state).to(dt),
                              lambda a, b: get_loss("NCC")(a, b,
                                                           method=method),
                              *(x.to(dt) for x in pair))[1]
                 for dt in (torch.float32, torch.float64)]
        out[method] = (max(float((a.double() - b).abs().max())
                           for a, b in zip(*grads))
                       / max(float(b.abs().max()) for b in grads[1]))
    return out


def phase_affine(seed, smi):
    """nets/affine_net.py at full size, 2-D and 3-D: AFFINE_STEPS Adam
    steps on a pair made by a known affine, the loss falling, ms a step,
    peak memory; card vs CPU the first two steps' losses, and the
    gradients (AFFINE_CHECK_KW's loss) from the initial weights (fc_theta
    starts at zero: only it has a gradient) and from the card's weights
    after the first step (every parameter has one).  The affine warp
    samples absolute coordinates with the plain gather (as JAX's XLA
    path; no Pallas kernel serves it): no launch."""
    out = {}
    for i, (name, (shape, loss_name)) in enumerate(AFFINE_CASES.items()):
        loss_fn = get_loss(loss_name)
        pair = affine_pair(shape, seed + i)
        moving, fixed = (x.to(DEVICE) for x in pair)
        net = affine_net(shape, seed + i, DEVICE)
        opt = torch.optim.Adam(net.parameters(), lr=AFFINE_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_cuda.reset_launches()
        losses, states, ms = [], [], []
        for _ in range(AFFINE_STEPS):
            states.append({k: v.detach().cpu().clone()
                           for k, v in net.state_dict().items()})
            t0 = time.perf_counter()
            opt.zero_grad()
            warped, matrix, flow = net(moving, fixed)
            loss = loss_fn(warped, fixed)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
        launches = dict(warp_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        cpu_losses = [affine_grads(affine_net(shape, seed + i, "cpu",
                                              states[k]), loss_fn, *pair)[0]
                      for k in (0, 1)]
        cpu_s = time.perf_counter() - t0
        rel = [abs(losses[k] - r) / abs(r) for k, r in enumerate(cpu_losses)]
        check_kw = AFFINE_CHECK_KW.get(loss_name, {})

        def check_fn(a, b):
            return loss_fn(a, b, **check_kw)

        grads, ref = ([affine_grads(affine_net(shape, seed + i, dev,
                                               states[k]),
                                    check_fn, *(x.to(dev) for x in pair))
                       for k in (0, 1)] for dev in (DEVICE, "cpu"))
        g_max = [max(float(g.abs().max()) for g in r[1]) for r in ref]
        g_err = [max(float((a - b).abs().max())
                     for a, b in zip(c[1], r[1]))
                 for c, r in zip(grads, ref)]
        moved = sum(int(bool(g.abs().max() > 0)) for g in ref[1][1])
        conditioning = (ncc_f32_vs_f64(shape, seed + i, pair, states[0])
                        if loss_name == "NCC" else None)
        row = {"phase": "affine", "case": name, "shape": list(shape),
               "loss": loss_name, "check_kw": check_kw, "lr": AFFINE_LR,
               "losses": losses,
               "card_vs_cpu_loss_rel": rel, "grad_max": g_max,
               "grad_err_over_max": [e / m for e, m in zip(g_err, g_max)],
               "step2_tensors_with_grad": [moved, len(ref[1][1])],
               "ncc_f32_vs_f64_cpu": conditioning,
               "matrix_last": matrix[0].detach().tolist(),
               "flow_max_px": float(flow.detach().abs().max()),
               "launches": launches, "ms_per_step": ms,
               "ms_per_step_median": statistics.median(ms[1:]),
               "peak_gb": gb(peak), "cpu_s": cpu_s, "card": smi}
        emit(row)
        if launches != ZERO:
            raise AssertionError(f"{name}: {launches} launches; the affine "
                                 f"path launches no kernel")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall: {losses}")
        if not max(rel) <= PATH_TOL:
            raise AssertionError(f"{name}: loss card vs CPU {rel}")
        for e, m in zip(g_err, g_max):
            if not (m > 0 and e <= GRAD_ENV * m):
                raise AssertionError(f"{name}: gradients card vs CPU {e} > "
                                     f"{GRAD_ENV} * {m}")
        if conditioning and not conditioning["conv"] <= GRAD_ENV:
            raise AssertionError(f"{name}: NCC's conv method's float32 "
                                 f"gradient {conditioning}: no check")
        if moved != len(ref[1][1]):
            raise AssertionError(f"{name}: the second step reaches "
                                 f"{moved} of {len(ref[1][1])} tensors")
        out[name] = ms
    return out


LOSS_TOL = 1e-4
LOSS_B, LOSS_S, LOSS_V = 8, 256, 160   # batch, image side, volume side


def loss_cases(seed):
    """Every DICT_LOSSES name (and smooth_loss_3d, NMI at 160^3, NT-Xent)
    at the main paths' shapes: name -> (fn, CPU args, kwargs)."""
    gen = torch.Generator().manual_seed(seed)
    B, S, V = LOSS_B, LOSS_S, LOSS_V

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    a = torch.tanh(randn(B, 1, S, S))
    b = torch.tanh(a + 0.3 * randn(B, 1, S, S))
    mask = (torch.rand((B, 1, S, S), generator=gen) > 0.3).float()
    logits = randn(B, 4, S, S) * 2
    onehot = F.one_hot(torch.randint(0, 4, (B, S, S), generator=gen),
                       4).permute(0, 3, 1, 2).float()
    q, k = (F.normalize(randn(256, 256), dim=1) for _ in range(2))
    va = torch.tanh(randn(1, 1, V, V, V))
    vb = torch.tanh(va + 0.3 * randn(1, 1, V, V, V))
    disc = randn(1, 1, 4, 4) * 0.3
    alpha = torch.rand((B, 1, 1, 1), generator=gen)

    def disc_fn(x):
        return torch.tanh(F.conv2d(x, disc.to(x.device), stride=2))

    return {
        "L1": (get_loss("L1"), (a, b, mask), {}),
        "L2": (get_loss("L2"), (a, b, mask), {}),
        "TukeyBiweight": (get_loss("TukeyBiweight"), (a, 2 * b),
                          {"mask": mask}),
        "PatchNCE": (get_loss("PatchNCE"), (q, k), {}),
        "Grad": (get_loss("Grad"), (randn(B, 2, S, S) * 2,), {}),
        "NCC": (get_loss("NCC"), (a, b), {"mask": mask}),
        "NMI": (get_loss("NMI"), (a, b), {}),
        "CrossEntropy": (get_loss("CrossEntropy"), (logits, onehot), {}),
        "NLL": (get_loss("NLL"), (torch.log_softmax(logits, 1), onehot), {}),
        "Dice": (get_loss("Dice"), (torch.softmax(logits, 1), onehot), {}),
        "WGAN": (get_loss("WGAN"), (randn(B, 1, 30, 30), True), {}),
        "LSGAN": (get_loss("LSGAN"), (randn(B, 1, 30, 30), False), {}),
        "GradPenGAN": (get_loss("GradPenGAN"), (disc_fn, a, b),
                       {"alpha": alpha}),
        "smooth_loss_3d": (smooth_loss_3d, (randn(1, 3, V, V, V),), {}),
        "NMI_3d": (get_loss("NMI"), (va, vb), {}),
        "nt_xent": (nt_xent_loss, (randn(256, 128), randn(256, 128)), {}),
    }


def to_dev(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def phase_losses(seed, smi):
    """The loss registry on the card against the CPU (LOSS_TOL relative of
    the largest value; PatchNCE's per-patch losses), ms a call; deepsim
    with a small random conv extractor (3 taps)."""
    cases = loss_cases(seed)
    if set(DICT_LOSSES) - set(cases):
        raise AssertionError(f"names not driven: "
                             f"{set(DICT_LOSSES) - set(cases)}")
    rows = {}
    for name, (fn, args, kw) in cases.items():
        dargs = [to_dev(x, DEVICE) for x in args]
        dkw = {k: to_dev(v, DEVICE) for k, v in kw.items()}
        card = fn(*dargs, **dkw).detach()
        ref = fn(*args, **kw).detach()
        err = float((card.cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        rows[name] = {"value": float(card.float().mean()),
                      "rel_err": err / max(scale, 1e-12),
                      "ms": time_ms(lambda: fn(*dargs, **dkw), reps=10,
                                    warmup=2)}
        if not err <= LOSS_TOL * scale:
            raise AssertionError(f"loss {name}: card vs CPU {err} > "
                                 f"{LOSS_TOL} * {scale}")
    gen = torch.Generator().manual_seed(seed + 1)
    widths = (1, 8, 16, 16)
    ws = [torch.randn((co, ci, 3, 3), generator=gen) * 0.4
          for ci, co in zip(widths, widths[1:])]

    def extractor_on(device):
        wd = [w.to(device) for w in ws]

        def extract(x):
            feats = []
            for w in wd:
                x = torch.tanh(F.conv2d(x, w, padding=1, stride=2))
                feats.append(x)
            return feats
        return extract

    a, b = cases["L1"][1][:2]
    ds = deepsim(a.to(DEVICE), b.to(DEVICE), extractor_on(DEVICE))
    ds_ref = deepsim(a, b, extractor_on("cpu"))
    rows["deepsim"] = {"value": ds, "rel_err": abs(ds - ds_ref) / abs(ds_ref),
                       "ms": time_ms(lambda: deepsim(
                           a.to(DEVICE), b.to(DEVICE), extractor_on(DEVICE)),
                           reps=10, warmup=2)}
    emit({"phase": "losses", "tol": LOSS_TOL, "losses": rows, "card": smi})
    if not rows["deepsim"]["rel_err"] <= LOSS_TOL:
        raise AssertionError(f"deepsim: card vs CPU {rows['deepsim']}")
    return rows


MODES_SITES, MODES_SLICES = 3, 4
MODES_TEST = 2                       # test pairs of the triplet run
# 2 steps at B=1 (1 pair an epoch, 2 epochs), a print a step, no visuals
MODES_FLAGS = ["--max_dataset_size", "1", "--n_epochs", "1",
               "--n_epochs_decay", "1", "--save_epoch_freq", "1",
               "--print_freq", "1", "--display_freq", "1000"]


def write_site_data(root, seed, size):
    """patient_site's layout: MODES_SITES sites, each t1/ and t2/ with
    MODES_SLICES slices of the anatomy (t2 its inverted gamma)."""
    rng = np.random.default_rng(seed)
    for s in range(MODES_SITES):
        for k in range(MODES_SLICES):
            base = anatomy(rng, size)
            for mod, img in (("t1", base ** 1.1), ("t2", (1 - base) ** 0.6)):
                d = os.path.join(root, f"site_{s}", mod)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"slice_{k:02d}.png"),
                          np.clip(img * 255, 0, 255).astype(np.uint8))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fetch(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def phase_cli_modes(seed, smi):
    root = tempfile.mkdtemp(prefix="chip_smoke_modes_")
    try:
        with open(os.path.join(root, "modes.log"), "w") as log:
            return cli_modes_paths(root, log, seed, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def cli_modes_paths(root, log, seed, smi):
    """train.main on --dataset_mode patient_site and triplet (the default
    CUT model at full width), 2 steps each, launches exact; the triplet
    run with --display_id 1 on a free localhost port, its page and loss
    history fetched while it serves; test.main on the triplet run (JAX's
    test.py lists {dataroot}/testA for its output names, which a
    patient_site dataroot does not hold)."""
    sites, trip = os.path.join(root, "sites"), os.path.join(root, "trip")
    write_site_data(sites, seed, CLI_SIZE)
    write_cli_data(trip, seed + 1, CLI_SIZE)
    ck_dir = os.path.join(root, "ck")
    card = ["--gpu_ids", CLI_GPU, "--checkpoints_dir", ck_dir, "--seed",
            str(seed), *CLI_FLAGS]
    want = cli_train_launches(2, 1, 1000, 1, 0)
    out, rows = {}, {}
    for mode, data in (("patient_site", sites), ("triplet", trip)):
        argv = card + ["--dataroot", data, "--name", mode, "--dataset_mode",
                       mode, *MODES_FLAGS]
        port = free_port() if mode == "triplet" else None
        if port:
            argv += ["--display_id", "1", "--display_port", str(port)]
        trained, launches = run_counted(log, train_cli.main, argv)
        check_launches(f"cli {mode}, 2 steps", launches, want)
        out[f"cli_{mode}"] = launches
        losses = {k: float(v)
                  for k, v in trained["model"].get_current_losses().items()}
        recs = losses_of(os.path.join(ck_dir, mode))
        row = {"steps": len(trained["step_s"]),
               "ms_per_step": [s * 1e3 for s in trained["step_s"]],
               "losses": losses}
        vis = trained["visualizer"]
        if port:
            host, bound_port = vis.plot_server[0].server_address[:2]
            page_status, page = fetch(f"http://127.0.0.1:{port}/")
            _, hist = fetch(f"http://127.0.0.1:{port}/history")
            served = json.loads(hist)
            vis.close()
            last = served[-1]["losses"] if served else {}
            row["display"] = {"host": host, "port": bound_port,
                              "page_status": page_status,
                              "records": len(served)}
            if not (host == "127.0.0.1" and bound_port == port
                    and page_status == 200 and mode.encode() in page
                    and served == recs and all(
                        math.isclose(last.get(k, math.nan), v, rel_tol=1e-6)
                        for k, v in losses.items())):
                raise AssertionError(f"the dashboard on port {port} served "
                                     f"{row['display']}, {last}; the step's "
                                     f"losses are {losses}")
        rows[mode] = row
    res_dir = os.path.join(root, "results")
    tested, launches = run_counted(
        log, test_cli.main, card + ["--dataroot", trip, "--name", "triplet",
                                    "--dataset_mode", "triplet",
                                    "--results_dir", res_dir, "--num_test",
                                    str(MODES_TEST)])
    check_launches("test triplet", launches,
                   add_counts((MODES_TEST, TEST_PAIR_LAUNCHES)))
    out["cli_triplet_test"] = launches
    written = sorted(os.listdir(os.path.join(trip, "deform_trainA")))
    if tested["n_pairs"] != MODES_TEST or len(written) != MODES_TEST:
        raise AssertionError(f"test triplet: {tested['n_pairs']} pairs, "
                             f"wrote {written}")
    rows["triplet_test"] = {"pairs": tested["n_pairs"],
                            "ms_per_pair": [s * 1e3
                                            for s in tested["pair_s"]]}
    emit({"phase": "cli_modes", "runs": rows, "launches": out, "card": smi})
    return out


def kernel_row(name, replaces, source, launches, main_path, rows, main,
               slab_cases=()):
    """One kernel's entry of the kernels line: its numbers at its main
    path's case, its launches by path (``launches`` is the main path's),
    and its slab form's cases (each with its own ms, bound and error)."""
    r = rows[main]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[main_path],
            "launches_by_path": launches,
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({"bit_reproducible": all(x["bit_reproducible"]
                                        for x in rows.values())}
               if "bit_reproducible" in r else {}),
            **({"binned_max_abs_err": max(x["binned_max_abs_err"]
                                          for x in rows.values())}
               if "binned_max_abs_err" in r else {}),
            **({"fixed_max_abs_err": max(x["fixed_max_abs_err"]
                                         for x in rows.values())}
               if "fixed_max_abs_err" in r else {}),
            **{key: r[key] for key in ("per_step_us", "fixed_us",
                                       "device_us_per_launch", "ms_inference",
                                       "inference_bound_ms")
               if key in r},
            **({"slab_cases": list(slab_cases)} if slab_cases else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace register calls and train steps with "
                         "torch.profiler")
    ap.add_argument("--steps", action="store_true",
                    help="only build and phase chain_steps (the chains at "
                         "nsteps 1..7, one barrier alone); no result line")
    ap.add_argument("--recipe3d", action="store_true",
                    help="only build and phase recipe3d (the 64^3 recipe "
                         "trained and scored through the command line); "
                         "no result line")
    ap.add_argument("--recipe_epochs", type=int, default=600,
                    help="epochs of --recipe3d (half decaying)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail_line("no CUDA device: torch.cuda.is_available() is false; "
                  "this script runs on the card only")
        return 2

    wall = {}

    def run(name, fn, *fn_args):
        t0 = time.perf_counter()
        try:
            out = fn(*fn_args)
        except BaseException as err:
            fail_line(err, phase=name)
            err.chip_smoke_reported = True
            raise
        wall[name] = time.perf_counter() - t0
        emit({"phase": name, "wall_s": wall[name]})
        return out

    smi = run("device", phase_device)
    run("build", phase_build)
    if args.steps:
        run("chain_steps", phase_chain_steps, args.seed)
        return 0
    if args.recipe3d:
        run("recipe3d", phase_recipe3d, args.seed, smi, args.recipe_epochs)
        return 0
    fwd_rows = run("kernel", phase_kernel, args.seed, args.profile)
    bwd_rows = run("kernel_bwd", phase_kernel_bwd, args.seed, args.profile)
    run("host_path", phase_host_path, args.seed)
    chain_rows = run("kernel_chain", phase_kernel_chain, args.seed,
                     args.profile)
    # early, while this process holds little of the card: its two 3-D
    # ranks take about 33 GB each
    spatial_joint_launches, slab_joint_rows = run(
        "spatial_joint", phase_spatial_joint, args.seed, smi)
    torch.cuda.empty_cache()
    spatial_options_launches = run("spatial_options", phase_spatial_options,
                                   args.seed, smi)
    torch.cuda.empty_cache()
    spatial_zoo_launches = run("spatial_zoo", phase_spatial_zoo, args.seed,
                               smi)
    torch.cuda.empty_cache()
    model, reg_launches, reg_ms = run("register", phase_register, args.seed,
                                      smi)
    if args.profile:
        run("profile_register", phase_profile, model, args.seed, reg_ms)
    del model
    model, train_launches, train_ms = run("train", phase_train, args.seed,
                                          smi)
    if args.profile:
        run("profile_train", phase_profile_train, model, args.seed, train_ms)
    del model
    torch.cuda.empty_cache()
    fastcut_launches, _ = run("fastcut", phase_fastcut, args.seed, smi,
                              train_ms)
    gan_launches, _ = run("gan", phase_gan, args.seed, smi, train_ms)
    bf16_reg_launches, bf16_launches, _, _ = run(
        "bf16", phase_bf16, args.seed, smi, reg_ms, train_ms)
    dropout_launches = run("dropout", phase_dropout, args.seed, smi)
    torch.cuda.empty_cache()
    zoo_f32 = {}
    zoo_launches = run("zoo", phase_zoo, args.seed, smi, reg_ms, train_ms,
                       zoo_f32)
    torch.cuda.empty_cache()
    bf16_zoo_launches = run("bf16_zoo", phase_bf16_zoo, args.seed, smi,
                            zoo_f32)
    torch.cuda.empty_cache()
    cli_launches = run("cli", phase_cli, args.seed, smi, train_ms)
    rows3d = run("kernel3d", phase_kernel3d, args.seed, args.profile)
    chain3d_rows = run("kernel_chain3d", phase_kernel_chain3d, args.seed,
                       args.profile)
    eng, pair, reg3d_launches, train3d_launches, step3d_ms = run(
        "vxm3d", phase_vxm3d, args.seed, smi)
    if args.profile:
        run("profile_train3d", phase_profile_vxm3d, eng, pair, step3d_ms)
    del eng, pair
    torch.cuda.empty_cache()
    cli3d_launches = run("cli3d", phase_cli3d, args.seed, smi, step3d_ms)
    torch.cuda.empty_cache()
    joint3d_launches, j3d_reg_ms, j3d_step_ms = run(
        "joint3d", phase_joint3d, args.seed, smi, args.profile)
    torch.cuda.empty_cache()
    bf16_3d_launches = run("bf16_3d", phase_bf16_3d, args.seed, smi,
                           j3d_reg_ms, j3d_step_ms)
    torch.cuda.empty_cache()
    zoo3d_launches = run("zoo3d", phase_zoo3d, args.seed, smi, j3d_reg_ms,
                         j3d_step_ms)
    torch.cuda.empty_cache()
    dp_launches = run("dp", phase_dp, args.seed, smi)
    dp_nccl_launches = run("dp_nccl", phase_dp_nccl, args.seed, smi)
    dp3d_launches = run("dp3d", phase_dp3d, args.seed, smi)
    spatial3d_launches, slab3d_rows = run("spatial3d", phase_spatial3d,
                                          args.seed, smi)
    dp_cli_launches = run("dp_cli", phase_dp_cli, args.seed, smi)
    torch.cuda.empty_cache()
    augment_launches = run("augment", phase_augment, args.seed, smi)
    run("affine", phase_affine, args.seed, smi)
    run("losses", phase_losses, args.seed, smi)
    torch.cuda.empty_cache()
    modes_launches = run("cli_modes", phase_cli_modes, args.seed, smi)

    paths = {"register": reg_launches, "train": train_launches,
             "fastcut": fastcut_launches, "gan": gan_launches,
             "bf16_register": bf16_reg_launches, "bf16_train": bf16_launches,
             "dropout": dropout_launches, **zoo_launches,
             **bf16_zoo_launches,
             "register3d": reg3d_launches, "train3d": train3d_launches,
             **cli_launches, **cli3d_launches, **joint3d_launches,
             **bf16_3d_launches, **zoo3d_launches, **dp_launches,
             "dp_nccl": dp_nccl_launches, "dp3d": dp3d_launches,
             **spatial3d_launches, **spatial_joint_launches,
             **spatial_options_launches, **spatial_zoo_launches,
             **dp_cli_launches, **augment_launches, **modes_launches}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    src2d, src3d = ("dfmir_tpu_torch/csrc/warp2d.cu",
                    "dfmir_tpu_torch/csrc/warp3d.cu")
    tpu = "dfmir_tpu/ops/warp_pallas.py"
    emit({"kernels": [
        kernel_row(FWD, f"{tpu}:143", src2d, by_path(FWD), "train",
                   fwd_rows, MAIN_CASE, slab_joint_rows[FWD]),
        kernel_row(BWD, f"{tpu}:972", src2d, by_path(BWD), "train",
                   bwd_rows, MAIN_BWD_CASE, slab_joint_rows[BWD]),
        kernel_row(VF, f"{tpu}:143", src2d, by_path(VF), "train",
                   chain_rows[VF], MAIN_CHAIN_CASE),
        kernel_row(VB, f"{tpu}:972", src2d, by_path(VB), "train",
                   chain_rows[VB], MAIN_CHAIN_CASE),
        kernel_row(FWD3D, f"{tpu}:356", src3d, by_path(FWD3D), "train3d",
                   rows3d[FWD3D], MAIN3D_CASE[FWD3D],
                   [r for r in slab3d_rows if r["kernel"] == FWD3D]),
        kernel_row(DFLOW3D, f"{tpu}:576", src3d, by_path(DFLOW3D),
                   "train3d", rows3d[DFLOW3D], MAIN3D_CASE[DFLOW3D],
                   [r for r in slab3d_rows if r["kernel"] == DFLOW3D]),
        kernel_row(DSRC3D, f"{tpu}:643", src3d, by_path(DSRC3D),
                   "joint3d_train", rows3d[DSRC3D], MAIN3D_CASE[DSRC3D],
                   slab_joint_rows[DSRC3D]),
        kernel_row(VF3, f"{tpu}:356", src3d, by_path(VF3), "train3d",
                   chain3d_rows[VF3], MAIN_CHAIN3D_CASE),
        kernel_row(VB3, f"{tpu}:576", src3d, by_path(VB3), "train3d",
                   chain3d_rows[VB3], MAIN_CHAIN3D_CASE),
    ], "wall_s": wall})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as err:
        # every failure ends the run non-zero with a result line on stdout
        if not getattr(err, "chip_smoke_reported", False):
            fail_line(err)
        raise
