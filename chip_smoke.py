#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (habitat_torch) runs on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build   nvcc compiles every CUDA source of the port (one per source, all
           started together) into habitat_torch/build/.
2. setup   host scenes and envs: the bench PointNav configuration, the
           mid-size scene, and the scan-scale scene at full width
           (generate_scan_apartment(0, tess=0.04, n_clutter=40) with
           build_lod_scene(cells=(0.08, 0.25, 0.6), bands=(1.2, 3.0, 8.0)):
           859,290 triangles, 16 episodes, N=256).
3. kernels each kernel's wrapper runs on the card at the shapes the render
           and update paths give it and is held against its plain PyTorch
           version on the same inputs: the frustum-selected kernel on the
           bench reset, the every-chunk kernel on the mid-size route's reset
           and on a synthetic 8192-triangle pack, the chunklet stream and the
           chunk stream kernels on the scan env's reset (N=256, 128x128, 16
           tiles of 32x32 pixels), the cull-mask kernel on that reset's head,
           the stem max pool's backward at the bench update's minibatch
           (4096 x 32 x 64 x 64 bf16, channels-last as the stem hands it
           over) on a ReLU of normal noise and on an input full of positive
           ties (bit-equal), and on a tie-free float32 input against
           F.max_pool2d's own gradient; the general route's index kernel
           on the panoramic bench reset (N=256, 128x256 equirect) and on
           the mid-size scene's fisheye reset (N=16, 128x128), and its
           culled kernel on the scan env's equirect reset (N=32, 128x256,
           chunks of 256, K=160; its winner's 8 attributes must equal the
           plain version's where the winner does). The ray-batch kernels:
           #8 (raycast_index, row-major features) on the bench reset's rays,
           also held against #3 on the same rays; #9 (raycast_culled) on #7's
           inputs with its 256-triangle ids split into 128-triangle ones,
           bit-equal to #7's output on every ray; #10 (raycast_tilecull_t) on #1's
           inputs with attr16_table(pack), t and all 16 rows equal to its
           plain version's on every ray, its gid equal to #1's winner on
           every ray and its t against the pinhole route's plane-exact t. Then
           the ray-batch path: raycast_batch, raycast_culled and
           raycast_tilecull_t once each, counted.
           Closest-hit gates: hit/miss agreement >= 0.9999, winner-id
           agreement >= 0.999 (shared-edge near-ties), |dt| < 5e-3 m where
           the winner is the same. Cull mask: agreement >= 0.9999 on gated
           slots and the same chunklet lists from select_chunklets_exact
           with the kernel's mask as with the plain version's. Each is timed
           with CUDA events beside its plain version and its bound on this
           card; the stream kernels' bound counts only the chunks a ray's
           final hit leaves it to test, and every closest-hit kernel's bound
           counts the whole test only for pairs whose ray line meets the
           triangle (the rest end before tnum; the plain versions count
           them), beside the bound by the old rule (every test whole); #10's
           adds its epilogue's operations and bytes.
           The rows of the stream kernels (#4, #5) and the ring kernels (#1,
           #2, #3, #7, #8, #9, #10) carry their design as their libraries report
           it (rays per thread and per block, ring depth, registers, spills,
           shared memory, blocks per SM), which must match the wrappers'
           constants; those of the cull mask (#6) and the max-pool backward
           (#11) carry theirs (no spills), their achieved TB/s and their
           share of the bound.
4. paths   the main path: the bench PointNav configuration (4 procedural
           scenes, 64 episodes, N=256 envs, 128x128 depth+RGB+pointgoal,
           resnet18 base 32 / 16 groups + LSTM-512, 4 actions, T=32) with
           weights from torch.manual_seed(0): reset, one warm-up rollout and
           ROLLOUTS timed rollouts through PPOLearner.collect_rollout (median
           and range of their env-steps/s), per-layer times, and one rollout
           under torch.profiler (device kernel time, idle share, launches,
           top kernels). Then the mid-size-scene route (one 4226-triangle
           scene padded to 4352, N=16, T=4), which renders through the
           every-chunk kernel. Then the scan path: the same rollout on the
           scan env (warm-up, SCAN_ROLLOUTS timed, per-step times of the
           render and of its stages, select / kernel / epilogue, each timed
           on its own, a profiled rollout),
           one reset render with backend="stream", and one whose cull mask
           comes from the plain version, which must give the default route's
           frames. Launch counters are zeroed just before each
           path and read just after; every render of a path must have
           launched its kernel.
5. exact   the scan route against the band-valid all-chunks oracle (every
           chunk whose LOD band holds the camera, through the chunk stream
           kernel) at 64x64, two poses, both with plane-exact t.
6. train   the bench train step, PPOLearner.train_step with
           PPOConfig(num_steps=32, num_mini_batch=2, ppo_epoch=2) at N=256:
           a warm-up and TRAIN_STEPS timed steps (median and range of train
           env-steps/s, rollout / update split, peak memory, finite losses),
           one update under torch.profiler (with the max-pool backward's
           share of its device time, and whether autograd hands that
           backward dy channels-last or it copies); then the same train step
           on the scan env (a warm-up and SCAN_TRAIN_STEPS timed). The max-pool
           backward kernel must launch 4 times per train step and no plain
           version may run on a card tensor.
7. check   env + render + policy on the card against the same code on the
           CPU (plain kernel versions) on a small input, and one update
           (N=8, T=4, ppo_epoch=2, one minibatch) from the same weights and
           batch on both: in bf16 from the policy the paths trained (losses,
           pooled share of parameter changes within lr/10), and in float32
           from each of the fixed starts built on the CPU (check_start: each
           of CHECK_SEEDS, then CHECK_CPU_STEPS train steps) with cuDNN's
           deterministic algorithms on the card (each trained tensor changed
           on both devices, its share within lr/10 at least
           UPDATE_TENSOR_SHARE; a planted fault in the pool backward must
           fail that gate).
8. pano    the panoramic main path at full width: the bench
           configuration with HabitatSimEquirectangularDepthSensor and
           HabitatSimEquirectangularRGBSensor at 128x256 in place of the
           pinhole pair and the policy built for 128x256: reset, a warm-up
           and PANO_ROLLOUTS timed rollouts, render ms per step and its
           stages, then a
           warm-up and PANO_TRAIN_STEPS timed train steps (peak memory,
           finite losses); every render launches the index kernel and no
           other. Then the scan env with the same cameras at N=32: reset and
           PANO_SCAN["steps"] env steps through the culled kernel, render
           ms and its stages, select / kernel / epilogue, each timed on its
           own, the share of rays hit.
           It runs after [check], which then meets the card as the earlier
           paths leave it.
9. exact   the culled route on CULLED_GUARD_ENVS envs of the scan equirect
           reset against #3 over every chunk whose LOD band holds the
           camera: hitmatch at least CULLED_HITMATCH and t agreement within
           5 mm on at least CULLED_T_AGREE of common hits.
10. dynamic three boxes of 12 triangles per env in front of each camera,
           merged by closest hit on the index route (bench scenes, N=256,
           128x128, pitch -0.45), the block route (scan scene, N=256) and the
           culled route (scan scene, N=32, 128x256 equirect): frames equal
           to those with #3's plain version swapped in, the share of pixels
           the boxes take, render ms with and without them (on the index
           case also the index route's own static render), #3's extra
           launches per render.
11. flagship-eval  the flagship PointNav checkpoint, exported without JAX
           (habitat_torch/weights/flagship_pointnav.pt), evaluated by
           habitat_torch.baselines.flagship's protocol: 64 held-out procedural
           scenes (seed 91000), N=64, 128x128 depth + pointgoal, greedy, the
           first 4 episodes of each env within 850 env steps. It must count
           256 episodes with success and SPL within 0.03 of the JAX
           package's 0.9414 and 0.8919 on the same episodes; #1 must launch
           once per render (the reset's and one per env step) and no plain
           version may see a card tensor.

12. contacts  rearrangement physics at the Pick configuration's scale (N=128
           envs, 3 boxes each; PyTorch ops, no kernel of the port's):
           settle_objects (30 contacts-v3 steps, every valid box on or above
           its floor), then 90 steps (of the env's 300-step episode) of
           the v6 contact_step (dt 0.1, 4 substeps) with boxes of
           0.05-0.20 m half-extents spawned overlapping, floating and tipped
           and the robot driven through them: ms per step (median and range
           of three runs of 30 steps), launches per step and the idle share
           from 1 profiled step, no host sync in a step. Gates: one step on the
           card against the CPU from the same states (steps 0 and 30), held
           to the CPU's float64 result (PHYS_ATOL, PHYS_W_RTOL, FORCE_ATOL,
           FORCE_RTOL, plus twice the CPU float32 error); after 90 steps
           the shares of boxes asleep and tipped within SHARE_GAP of the
           CPU's episode and no corner FLOOR_SINK below its floor.
    arm    Fetch's step_arm (7 joints, the env's motors, dt 1/30, 4
           substeps) for 300 calls at N=128 toward seeded targets (ms per
           call, launches, no host sync in a call; calls 0, 1, 10, 100
           and 299 held to the CPU's float64 result; every joint within
           ARM_TRACK of its target at the end) and ik_solve (8 iterations)
           toward reachable targets (ms, launches, held to float64, final
           error within IK_MEDIAN_ERR / IK_MAX_ERR). No kernel launches in
           either phase.
13. pick   vision Pick trained at full width (PICK: the repo's
           scripts/train_pick_vision_tpu.py configuration, N=128, 64x64
           head depth + RGB, resnet9 + LSTM-128 with the rearrangement state
           sensors, PPO T=64 in 2 minibatches and 2 epochs, weights from
           torch.manual_seed(0)): reset, a warm-up and PICK_TRAIN_STEPS
           timed train steps (median and range of train env-steps/s,
           rollout / update split, peak memory, finite losses), then one env
           step's ms and its render, the synchronising calls a step makes
           with the render (counted) and none without it (checked), and
           the greedy controller of tests/test_rearrange.py for
           PICK_GREEDY_STEPS steps. Gates: #3 launched twice per render (the
           reset's and 64 per rollout), #11 4 times per train step, no plain
           version on a card tensor; some env picks its target, and every
           pick reads pick_success 1 with a reward of at least the success
           reward.
    pick-contacts  pick_procgen.yaml's values (PICK_CONTACTS: contacts v6,
           128x128 cameras, 2 scenes x 16 episodes) at N=128: the settled
           reset and the greedy controller for PICK_CONTACTS_STEPS steps (ms per
           env step, its split into physics / render / rest, launches and
           idle share from 3 profiled steps, no host sync without the
           render). Gates at N=PICK_CHECK_ENVS from the same states (the
           reset, and the target held): state sensors and reward within
           1e-5 of the CPU's; the contact step's outputs held to the CPU's
           float64 result as in [contacts]; held, done and success equal;
           the frames' hit/miss and semantics equal on >= PICK_FRAME_AGREE
           of pixels; #3 twice per render.
14. config the user's entry point from YAML (CONFIG_*): (a) `python -m
           habitat_torch.baselines.run --config-name=pointnav/
           ppo_pointnav_example` through run.main at the config's own width
           (16 envs, 128x128 depth, resnet18 + LSTM-512, T=32, 2 minibatches,
           2 epochs), CONFIG_UPDATES updates on the card, with TensorBoard
           output: #1 launched 1 + CONFIG_UPDATES x 32 times, #11 2 x 2 x
           CONFIG_UPDATES, no plain version on a card tensor; (b) `--run-type
           eval` from its `latest`: parameters bit-equal to the trained ones,
           test_episode_count // 16 episodes per env counted, success and SPL,
           #1 once per render; (c) env_from_config(pick_procgen.yaml,
           num_envs=128) equal to the [pick-contacts] env built by hand, bit
           for bit, at the reset and over CONFIG_GREEDY_STEPS greedy steps;
           (d) a declared-actions env (arm with a suction grip, base, stop;
           declared state sensors and measures) at N=128 under contacts:
           CONFIG_SPEC_STEPS steps under torch.cuda.set_sync_debug_mode
           ("error"), and CONFIG_SPEC_CHECKS of them against the CPU as in
           [pick-contacts], then the suction grip against the CPU from placed
           states: a held box kept and a box at the EE grabbed (the target
           held after the step in every env), a held box released (held
           nowhere after it, the contact step moving a box) and its fall over
           PICK_DROP_STEPS steps. The TensorBoard events file must exist.
           The phase must end within CONFIG_SECONDS.

15. objectnav  (a) env_from_config(objectnav_procgen.yaml, num_envs=16) at
           the yaml's widths (128x128 RGB + depth + semantic, 6 actions, 4
           scenes x 16 episodes): reset and ONAV_ENV["steps"] steps of
           ONAV_SCHEDULE (look_up and look_down among them); objectgoal, gps
           and compass held to the same env's state sensors on the CPU, step
           by step from the card's state, within NAV_OBS_ATOL; #1 launched
           once per render; #1 on 4 envs of the last state (nonzero pitch)
           against its plain version at the [kernel] gates. (b) the ObjectNav
           train recipe (ONAV_RECIPE: 16 scenes x 16 episodes, extent 8, N=128,
           64x64 depth, objectgoal, compass, gps, resnet9 + LSTM-192,
           RECIPE_PPO) for RECIPE_UPDATES updates: seconds per update,
           env-steps/s, rollout / update split, finite losses; #1 1 + 3 x 64,
           #11 3 x 2 x 2; an env step's ms, idle share and launches.
    imagenav  (a) env_from_config(imagenav_procgen.yaml, num_envs=16): the
           table's 128 goal images (128x128) in one #1 launch; their closest
           hit against #1's plain version on the same inputs; their RGB equal
           to the plain render on the CPU on >= GOAL_RGB_AGREE of pixels; the
           goal image constant over 4 steps and unlike each start view. (b)
           the ImageNav recipe (INAV_RECIPE: 8 scenes x 24 episodes, N=128,
           64x64 RGB and goal image, compass, gps, goal_keys=()): as (a) of
           [objectnav]; #1 1 (goal table) + 1 + 3 x 64, #11 twice per
           minibatch (the observation and the goal encoder).
    pick-arm  (a) the blind arm-Pick recipe (ARM_RECIPE: N=128, 8 scenes x
           16 episodes, one room, no clutter, 120 steps, arm control; the
           Gaussian resnet9 net without an encoder, LSTM-128) for
           RECIPE_UPDATES updates, no kernel launched; one float32 update (one
           epoch, one minibatch) from the rollout's start, card against CPU:
           losses within LOSS_RTOL, parameters within 2 lr. (b) the visual
           Gaussian policy policy_from_config builds for pick_procgen.yaml +
           ARM_OVERRIDES at N=32 (resnet18, LSTM-512, 128x128 head cameras,
           contacts): ARM_VISUAL["updates"] updates of T=32 (#3 twice per
           render, #11 once per minibatch), then evaluate_agent over 8
           deterministic episodes of an N=8 env from the same config (at most
           ARM_EVAL["max_steps"] steps; #3 twice per render).

16. ddppo  (a) `python -m habitat_torch.baselines.run --config-name=
           pointnav/ddppo_pointnav.yaml` through run.main at the recipe's
           widths (resnet50 base 32 / 16 groups, LSTM-512 x 2, 128x128
           depth, T=128, 2 epochs of 2 minibatches) and N=DDPPO["num_envs"]
           under a process group of one rank over NCCL (overrides: N,
           total_num_steps for DDPPO["updates"] updates, a temporary
           checkpoint folder, no TensorBoard): ms per update, rollout /
           update split, train env-steps/s, peak memory; #1 launched 1 +
           updates x 128 times, #11 updates x 4, no plain version on a card
           tensor; finite losses.
    ddppo-2rank  two processes on the card over gloo (card tensors), each
           with N/2 envs of DDPPO_2RANK (resnet18 or blind + LSTM-128,
           64x64 depth, float32, cuDNN deterministic): one train step held
           to the same step in one process on the card (ranks bit-equal;
           every element within DDPPO_RTOL / DDPPO_ATOL; every trained
           tensor moved).
    ppo-switches  one float32 update on the card against the CPU from the
           same start, batch and permutations (loss terms within
           SWITCH_RTOL; each tensor's share of elements within lr/10 at
           least UPDATE_TENSOR_SHARE, the tensors with elements beyond it
           logged, and a fault planted in the CPU update's action-head
           gradient must fail that rule): normalized advantage + linear LR
           decay, the Gaussian arm-Pick learner's adaptive entropy
           (log_alpha moves, clamped, equal), CPC|A on a GRU policy.

17. bc     behavior cloning of the geodesic follower at the bench's widths
           (BC: 4 procedural scenes x 16 episodes, N=128, T=32, 128x128
           depth + RGB + pointgoal, resnet18 base 32 / 16 groups + LSTM-512,
           bf16): a warm-up and BC_UPDATES timed updates (ms per update,
           rollout (env + teacher) / update split, env-steps/s, peak memory,
           the teacher's ms and launches per env step, idle share and
           launches of one profiled update). Gates: #1 launched 1 + 32 per
           update, #11 once per update, no plain version on a card tensor;
           #11 bit-equal to its plain version on the last update's stem-pool
           input; tests/test_il.py's learning gate from its initial weights
           (BC_GATE, BC_GATE_WEIGHTS); one float32 update of a blind net
           (BC_CHECK) on the card against the CPU: teachers equal, loss
           within SWITCH_RTOL, parameters by [check]'s per-tensor share rule.
    hrl    HRL-PPO at scripts/train_hrl_tpu.py's configuration (HRL_ENV,
           HRL_PPO: N=128, 16 macro steps of 8 env steps, the four oracle
           skills, no camera): a warm-up and HRL_UPDATES timed updates (ms,
           env-steps/s; an env step's launches and idle share); no kernel
           launched. Gates: the plan-table planner and the fixed plan complete
           a successful episode in HRL_PLANNER / HRL_FIXED's shares of envs
           on their tests' env (HRL_RULE_ENV), and at N=128 on [hrl]'s env
           the planner solves the same envs on the card as on the CPU;
           card against CPU at N=8 (HRL_CHECK): every step's skill index and
           action of a 100-step planner rollout equal, one HRL-PPO update
           with the same draws (losses, per-tensor share rule); run.main on
           an HRL experiment config (pick_procgen.yaml + updater HRLPPO)
           builds the trainer on the card and takes 2 updates.

18. vln    VLN behavior cloning at scripts/train_vln_tpu.py's configuration
           (VLN: N=128, 8 scenes x 16 episodes, 64x64 depth + instruction +
           GPS + compass, no goal sensor, resnet9 + LSTM-192 bf16, T=32, lr
           1.5e-3): a warm-up and VLN_UPDATES timed updates (ms, rollout /
           update split, env-steps/s, peak memory, idle share and launches
           of one profiled update). Gates: #1 1 + 32 per update, #11 once
           per update and bit-equal to its plain version on the last
           update's own input, no plain version on a card tensor;
           tests/test_eqa_vln.py::test_vln_seq2seq_il's rule (VLN_RULE);
           one float32 update of the blind net (VLN_CHECK) card against CPU:
           teachers equal, loss within BC_LOSS_RTOL, [check]'s per-tensor
           share rule.
    eqa-il the EQA imitation trainers (eqa-cnn-pretrain, vqa, pacman)
           through trainer_from_config on ppo_pointnav_example.yaml at
           N=128 (64x64 frames): a warm-up and 3 timed updates each (PACMAN
           after one collect_expert), ms per update and #1's exact count
           (the goal table, the reset, one per walk or expert step). Gates:
           the rules of test_eqa_cnn_pretrain_learns, test_vqa_learner and
           test_pacman_bc_loss_decreases on the card; one float32 step of
           each, card against CPU on the card's inputs.
    eqa-referent  PPO on the referent-EQA env at
           scripts/train_eqa_referent_tpu.py's widths (N=256, blind resnet9
           + LSTM-96, T=12, 2 x 2 minibatch steps; the table cut to 4 x 256
           episodes): a warm-up and EQA_REF_UPDATES timed train steps, no
           kernel launched; one float32 update card against CPU.
    agents PPOAgent from the flagship export, one observation at a time on
           one flagship env (N=1) for one episode: its action equal to the
           batched greedy policy's at every step, ms per act, success and
           SPL; GoalFollower on the same env (logged) and in an open room
           (AGENT_ROOM), where it must reach the goal; a sampling PPOAgent
           (seed 0: JAX's Threefry key split at every act, categorical by
           Gumbel noise) on the card beside the same agent on the CPU for
           AGENT_SAMPLED_STEPS acts: the noise bit-equal, the actions equal
           wherever the top two noisy logits lie more than twice the
           card-vs-CPU logit gap apart, ms per act.

19. env-api  the single-env API (ENV_API): (a)
           Benchmark(pointnav_procgen.yaml).local_evaluate of PPOAgent from
           the flagship export (deterministic) over 4 episodes at 128x128
           depth + pointgoal: success, SPL, ms per Env.step and per act, #1
           once per render, 3 profiled Env.steps (device ms, idle share,
           launches); (b) Env on the mini on-disk dataset
           (tests/assets/mini_dataset: PointNav-v1 episodes, a glb stage)
           with TopDownMap, RuntimePerfStats and GfxReplayMeasure, the same
           agent for all 8 episodes (at most 200 steps each), a
           BatchedEnv(N=1, auto_reset_done=False) stepped beside it from
           reset_to_fn with the same actions: observations, metrics, reward
           and done equal at every reset and step, the fog never shrinks,
           each episode's replay parses with steps + 1 keyframes, #1
           exactly 2 x (resets + steps) + 1 (Env.render()), no plain
           version on a card tensor, #1 on one step's frame and on a blind
           Env's 256x256 Env.render() frame against its plain version at
           the [kernel] gates; (c) the velocity path at N=128 on the bench
           scenes (128x128 depth + RGB, 32 steps of fixed commands, 16 envs
           auto-stopped): each step against the same env's state sensors
           on the CPU from the card's state (positions within
           VEL_POS_ATOL, dones equal), ms per step, #1 1 + 32.
    sim-api  the single-env simulator (SIM_API): TpuSim on
           generate_apartment(seed=0), 128x128 depth + RGB, walked by the
           ShortestPathFollower to a sampled goal (tests/test_env_api.py's
           rule: stop within 300 steps, within 0.6 m), then a teleport with a
           rotation and 4 velocity_control steps, a CPU TpuSim taking the
           same actions beside it (poses and collision flags equal, frames
           by the frame rule); render_env against the N=1 render_batch; the
           DebugVisualizer's 256x256 peek("scene") against the CPU's; #1
           exactly once per render, no plain version on a card tensor, #1 on
           the sim's rays against its plain version; sample_navigable_point
           card against CPU for 4,096 keys; ms per TpuSim.step, launches
           and idle share of 5 profiled steps.
    obs-transforms  the observation transforms at the config store's
           widths (OBS_TF: N=32 on the bench's 4 scenes): six 256x256 cube
           faces through #1, the native 256x512 equirect and 256x256
           fisheye through #3 (exact counts, no plain version on a card
           tensor); CubeMap2Equirect, CubeMap2Fisheye, Equirect2CubeMap,
           ResizeShortestEdge, CenterCropper and AddVirtualKeys on the
           card against the CPU on the same frames, ms per transform;
           tests/test_projections.py's rules at this size; #1 and #3 on these
           rays against their plain versions.

20. social  scripts/train_social_tpu.py's three modes at their widths
           (SOCIAL: N=128, 8 scenes x 16 episodes, seed 0): (a) single, a
           blind resnet9 + LSTM-128, T=64, 2 x 2 minibatch steps, the
           recipe's three measure keys; (b) vision, 64x64 head depth + RGB
           with the humanoid's 24 triangles as the render's dynamic pass, a
           visual resnet9, T=32; (c) two, TwoAgentPPOLearner with two blind
           resnet9 policies, T=64, one minibatch, 2 epochs. A warm-up and
           SOCIAL_UPDATES timed updates each (s per update, env-steps/s,
           rollout / update split, an env step's ms, launches and idle
           share). Gates: #3 exactly twice per render in (b) and nowhere
           else, #11 once per minibatch step in (b), no plain version on a
           card tensor; #11 bit-equal to its plain version on (b)'s last
           minibatch input; #3 on a (b) frame with the humanoid 1.2 m ahead
           against its plain version ([kernel] gates) and the humanoid on its
           pixels; (a)'s and (c)'s envs stepped SOCIAL_CHECK_STEPS steps on
           the card, each step also from the same state on the CPU env:
           state, observations, reward, done and measures within
           SOCIAL_ATOL; the rules of tests/test_social_nav.py::
           test_social_nav_visual_humanoid_visible and
           ::test_seek_success_reachable_by_scripted_follow and of
           tests/test_two_agent.py::test_both_agents_params_update; one
           float32 update of (a) and of both agents of (c), card against CPU
           on the card's rollout (the same permutations), from weights
           trained SOCIAL_START_UPDATES updates on the CPU: losses within
           LOSS_RTOL, [check]'s per-tensor share rule.
    hab3   Habitat 3.0's two-agent rearrangement from the config path:
           pick_procgen.yaml with a Spot main_agent and a humanoid agent_1
           (HAB3_OVERRIDES: the robot's arm and base velocity; the
           humanoid's oracle navigation, PDDL apply, joint action and pick;
           the multi-agent predicate sensor), N=128, contacts, the 128x128
           head render: HAB3['steps'] steps of a schedule driving every
           agent-1 action, each also from the same state on a CPU env
           without the camera (state, every non-visual observation and the
           predicates, reward, done, measures within SOCIAL_ATOL), #3
           exactly twice per render, no plain version on a card tensor, #3
           on one step's render against its plain version; ms per env step,
           launches, idle share; the assertions of tests/test_task_actions.py::
           test_hab3_two_agent_declared_actions and
           ::test_humanoid_joint_action_sets_root on the card at N=2 (as
           tests/test_torch_hab3.py applies them).

21. art-scene  rearrangement's articulated scenes (ART_SCENE: N=128, 8
           scenes x 16 episodes, one room per axis, 3 clutter boxes, 120
           steps): receptacle goals, tests/test_samplers.py's AO-state
           sampler and art_objs, the URDF cabinet through
           build_rearrange_table(art_asset=load_articulated_object(...)),
           task "open" with the 128x128 head render. Gates: a goal on a
           receptacle, every art_init_q in the sampler's range, art_goal_q the
           URDF's 0.42; tests/test_urdf_artobj.py's scripted opener opens a
           drawer past 0.36 within 200 steps (run on to ART_TIMED_STEPS for
           ms per env step);
           #3 exactly twice per render,
           no plain version on a card tensor; ART_CHECK_STEPS steps each also
           taken on the CPU from the card's state (card_vs_cpu_steps); #3 on
           a frame with each agent facing its cabinet against its plain
           version, the cabinet on >= ART_VIEW_SHARE of some env's pixels. ms
           per env step, launches, idle share.
    reach  tests/test_rearrange.py::test_reach_task_trains_to_success's
           recipe (N=32, arm control, blind Gaussian policy, hidden 64, T=16)
           trained to its rule (success > 0.6 after update 20, within 60), ms
           per update, no kernel launched; a step without host sync; the
           goal table of 4,096 episodes card against CPU (offsets bit-equal,
           goals within REACH_GOAL_ATOL); apply_relations,
           apply_relations_rotating, batched_within and batched_ontop at
           N=128 card against CPU.

22. vector-env  VEC_ENV: ThreadedVectorEnv and VectorEnv (forkserver) of 4
           RLTaskEnv(pointnav_procgen.yaml) workers at its 128x128 depth
           (worker i with habitat.seed 100 + i, the dataset cut to 4 x 4),
           64 batched steps with stops: every worker's returns equal an
           in-process card env's given the same actions; #1 once per render
           (threads: counted here; processes: read from each worker with
           call_at, the parent launching none); a worker whose step raises
           makes the parent raise within 30 s; close() leaves no live worker.
           ms per batched step for each variant.
    eval-video  evaluate_agent with the flagship weights on the flagship
           protocol's first 8 scenes at N=8, one greedy episode per env,
           video_option=("disk",) with a TopDownMapTracker: metrics equal to
           the same eval without video; #1 once per render; the GIF one
           frame per recorded step at round(100 / fps) cs; every frame equal
           to observations_to_image of its step's card observation; the
           debug camera's make_debug_video over a card TpuSim and
           DebugObservation.save (the PNG decodes to the image). ms per eval
           step with and without recording.
    clip   trainer_from_config for one update at N=16, T=32 of
           resnet50_clip_attnpool on pointnav_procgen.yaml (depth) and
           resnet50_clip_avgpool on objectnav_procgen.yaml (RGB + depth):
           #1 1 + 32 per config, no plain version on a card tensor; the
           trunk bit-unchanged, visual_fc moved; the first envs' features
           card against CPU within 2**-6 of the largest. ms per rollout step
           and update, launches and idle share of a rollout step.

Prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_FP32_FLOPS = 67e12  # published dense float32 peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # published HBM3 rate
# FP32 operations per ray-triangle test: 4 dots of length 10 (40 FMAs = 80
# flops), the margin (4 mul, 2 sub, 1 mul + 1 sub, 1 sub, 4 min, 1 compare)
# and the fold compare
FLOPS_PER_RAY_TRI = 95
# The stream and culled kernels sum tnum only where a ray's line meets the
# triangle (p, q, aa - p - q >= 0, aa above EPS^2: an "inside" pair); any
# other pair needs 3 dots (30 FMAs = 60 flops), aa, p, q, aa - p - q and
# their test (8): their bound counts this for every test and the rest of
# FLOPS_PER_RAY_TRI for the inside pairs
FLOPS_OUTSIDE = 68
# per ray: 10 features of 4 products and 3 sums
FLOPS_PER_RAY = 70
# per ray of the tile-cull epilogue: n.d (3 products, 2 sums), n.(v0 - o) (3
# differences, 3 products, 2 sums), |n.d| and its compare, the division, the
# shade (1 product, 1 sum), the hit compare
FLOPS_TILECULL_EPILOGUE = 18

BENCH = dict(num_envs=256, height=128, width=128, num_steps=32)
MID = dict(num_envs=16, num_steps=4, extent=30.0, n_clutter=420)
ROLLOUTS = 3  # timed bench rollouts after the warm-up one (cut from 5 to keep the script under 1,050 s on a slow host)
SCAN = dict(tess=0.04, n_clutter=40, cells=(0.08, 0.25, 0.6), bands=(1.2, 3.0, 8.0), triangles=859290)
SCAN_ROLLOUTS = 3  # timed scan rollouts after the warm-up one (cut from 5 to keep the script near 1,000 s)
TRAIN = dict(num_steps=32, num_mini_batch=2, ppo_epoch=2)  # bench.py's train step
TRAIN_STEPS = 2  # timed bench train steps after the warm-up one (cut from 5, then 3, for the script's time)
SCAN_TRAIN_STEPS = 2  # timed scan train steps after the warm-up one
PANO = dict(height=128, width=256)  # the equirect depth+RGB pair of [pano] and [pano-scan]
PANO_ROLLOUTS = 3  # timed panoramic rollouts after the warm-up one
PANO_TRAIN_STEPS = 2  # timed panoramic train steps after the warm-up one
PANO_SCAN = dict(num_envs=32, steps=4)  # [pano-scan]: N, env steps after the reset
CULLED_GUARD_ENVS = 4  # [exactness-culled]: envs of the scan equirect reset held to the oracle
# [exactness-culled]'s gates, just under its readings on the H100 (0.998245
# and 0.988482): the K=160 nearest chunks of a 1024-ray tile drop a few winners
CULLED_HITMATCH = 0.998
CULLED_T_AGREE = 0.985
# [dynamic]: the procedural rearrangement generator's object count, the
# rearrangement head camera's pitch, its first object semantic id
DYN = dict(objects=3, pitch=-0.45, sem_base=100)
# FP32 operations per input element of the max-pool backward: at most 4
# compares and 4 adds
FLOPS_PER_POOL_ELEMENT = 8
BF16_ATOL = 3e-2  # the port's bf16 policy against another implementation
# [check]: the least share of a trained tensor's elements whose card and CPU
# float32 update deltas agree within lr/10
UPDATE_TENSOR_SHARE = 0.99
# the same share pooled over all tensors in bf16; it reads 0.994-0.998 from
# run to run, since the policy reaching [check] was trained by [train]
BF16_POOLED_SHARE = 0.98
F32_ATOL = 1e-4  # float32 losses, card against CPU
# [check]'s float32 starts: the seeds of their weights, the float32 train
# steps of the N=8 CPU env each takes before it, and the CPU threads that
# run them
CHECK_SEEDS = (11, 12, 13)
CHECK_CPU_STEPS = 8
CHECK_THREADS = 8
# FP32 operations per (head slot, triangle) of the cull mask: 12 dots of 3
# products and 2 sums, 8 more sums, 3 subtractions, 12 compares
FLOPS_PER_CULL_TRI = 83
# [flagship-eval]'s gate, set before its first run: the JAX package's result
# on the same 256 episodes (scripts/eval_flagship_ckpt.py, 0.9414 success and
# 0.8919 SPL), within 0.03 (~8 of 256 episodes) for argmaxes that bf16 on
# the card flips
FLAGSHIP = dict(episodes=256, success=0.9414, spl=0.8919, tol=0.03)
# [contacts]: the Pick configuration's scale (N=128, scripts/train_rearrange_tpu.py:23;
# 3 boxes, generator.py:405), the env's step (dt 0.1, 4 substeps,
# rearrange_env.py:2225) over the first 90 steps of an episode of
# max_episode_steps 300 (cut to 90 steps for the script's time limit), timed
# in `runs` runs of 30 consecutive steps; settling as the generator runs it
# (30 contacts-v3 steps)
CONTACTS = dict(num_envs=128, objects=3, steps=90, dt=0.1, substeps=4, warmup=5, runs=3, profile_steps=1,
                settle_steps=30, robot_steps=60)
# [arm]: Fetch's 7 joints under the env's motors (kp 300, kd 30,
# rearrange_env.py:765) at the env's rate (dt 1/30, 4 substeps, :1742), 300
# calls timed in `runs` runs of 100, and its IK (8 iterations, :1756)
ARM = dict(num_envs=128, steps=300, dt=1.0 / 30.0, substeps=4, kp=300.0, kd=30.0, warmup=5, runs=3, ik_iters=8,
           ik_reps=20)
# [pick]: the repo's vision-Pick configuration (scripts/train_pick_vision_tpu.py:16-27):
# N=128, 8 scenes x 16 episodes, one room per axis, no clutter, 64x64 head
# depth + RGB, 120 steps, kinematic; resnet9 + LSTM-128 without a goal
# sensor and with the rearrangement state sensors; PPO T=64, 2 minibatches,
# 2 epochs. A warm-up and PICK_TRAIN_STEPS timed train steps, then the greedy
# controller of tests/test_rearrange.py:53-73 for PICK_GREEDY_STEPS steps.
PICK = dict(num_envs=128, task="pick", num_scenes=8, episodes_per_scene=16, seed=0, render_size=(64, 64),
            n_rooms_per_axis=1, n_clutter=0, max_episode_steps=120)
PICK_TRAIN = dict(num_steps=64, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4)
PICK_TRAIN_STEPS = 2
PICK_GREEDY_STEPS = 100
# [pick-contacts]: pick_procgen.yaml as habitat_torch/core/construct.py
# builds it (pick, discrete, Fetch, contacts, 128x128 head cameras, 2 scenes
# x 16 episodes, 2 rooms per axis, 3 clutter, 3 objects, 300 steps, success
# reward 10, slack -0.01) at the [contacts] scale N=128, seeded 0 (the yaml's
# habitat.seed is 100; [config] builds both with it): the reset (with
# settling) and the greedy controller for PICK_CONTACTS_STEPS steps; the card
# against the CPU at N=PICK_CHECK_ENVS, the greedy step that moved the most
# boxes among the states compared (seed 0's greedy episode moves boxes)
PICK_CONTACTS = dict(num_envs=128, task="pick", num_scenes=2, episodes_per_scene=16, seed=0, render_size=(128, 128),
                     n_rooms_per_axis=2, n_clutter=3, num_objects=3, max_episode_steps=300, success_reward=10.0,
                     slack_reward=-0.01, dynamics="contacts")
PICK_CONTACTS_STEPS = 64
PICK_CHECK_ENVS = 8
PICK_FRAME_AGREE = 0.999
PICK_DROP_STEPS = 3  # teacher-forced steps from a release: the box leaves the EE, falls, lands
# [config]: the user's entry point on the repo's example experiment at its own
# width (ppo_pointnav_example.yaml: 16 envs, 128x128 depth, resnet18 +
# LSTM-512, T=32, 2 minibatches, 2 epochs, test_episode_count 2), CONFIG_UPDATES
# updates; pick_procgen.yaml's env built from the config against the
# [pick-contacts] env built by hand over CONFIG_GREEDY_STEPS greedy steps; a
# declared-actions env (arm, base and stop specs) at N=128 for
# CONFIG_SPEC_STEPS steps without a host sync, CONFIG_SPEC_CHECKS of them
# and the suction grip's hold, grab and release against the CPU
CONFIG_EXPERIMENT = "pointnav/ppo_pointnav_example"
CONFIG_UPDATES = 3
CONFIG_GREEDY_STEPS = 3
CONFIG_SPEC_DECLARED = ("habitat.task.actions.arm_action.type=ArmAction",
                        "habitat.task.actions.arm_action.grip_controller=SuctionGraspAction",
                        "habitat.task.actions.base_velocity.type=BaseVelAction",
                        "habitat.task.actions.rearrange_stop.type=RearrangeStopAction",
                        "habitat.task.lab_sensors.joint.type=JointSensor",
                        "habitat.task.lab_sensors.ee_pos.type=EEPositionSensor",
                        "habitat.task.lab_sensors.is_holding.type=IsHoldingSensor",
                        "habitat.task.lab_sensors.target_start.type=TargetStartSensor",
                        "habitat.task.measurements.ee_to_object.type=EndEffectorToObjectDistance",
                        "habitat.task.measurements.pick_success.type=RearrangePickSuccess",
                        "habitat.task.measurements.force.type=RobotForce")
CONFIG_SPEC_STOP = 0.02  # the share of env steps whose rearrange_stop slot calls stop
CONFIG_SPEC_STEPS = 16
CONFIG_SPEC_CHECKS = (0, 7, 15)
CONFIG_SECONDS = 60.0
# in an env whose boxes the contact step moved, a state sensor or the reward
# is held to 1e-5 plus this many times the card's largest box-position gap:
# obj_start_sensor turns an xz offset (at most sqrt(2) of the largest
# component), the Pick reward's distance delta moves by at most sqrt(3) of it
MOVED_SENSOR_FACTOR = 2.0
# The physics gates, set before the first card run (PERF.md §6).
# One call on the card from a given state is held to the float64 result of
# the same code on the CPU: its largest error there within PHYS_ATOL (+
# PHYS_W_RTOL of the largest |omega| for angular velocities, FORCE_ATOL and
# FORCE_RTOL for the robot force) plus twice the CPU float32 result's own
# error (the robot contact and tumbling boxes are ill-conditioned: float32
# and float64 part by up to 1e-3 rad/s there in both packages).
PHYS_ATOL = 1e-5
PHYS_W_RTOL = 1e-5
FORCE_ATOL, FORCE_RTOL = 1e-3, 1e-4
# after the 90-step episode: the shares of free boxes asleep and tipped
# (body up axis below 0.9 of world up), card against CPU, and every box's
# lowest corner above its floor less this sink
SHARE_GAP = 0.05
FLOOR_SINK = 0.01
# [arm] tracking after 300 calls (the JAX package's test band, its gravity
# sag |c|/kp) and the IK's final error on reachable targets
ARM_TRACK = 0.1
IK_MEDIAN_ERR, IK_MAX_ERR = 0.02, 0.1


# [objectnav] (a): objectnav_procgen.yaml at its own widths, N=16, a fixed
# schedule of ONAV_STEPS env steps that looks up and down (actions: stop,
# forward, left, right, look_up, look_down), held to the CPU step by step
ONAV_ENV = dict(num_envs=16, steps=48, check_envs=4)
ONAV_SCHEDULE = (1, 4, 1, 2, 5, 5, 1, 3, 4, 1, 1, 2, 5, 1, 3, 4, 5, 1, 2, 1, 4, 5, 3, 1)
# the three train recipes (the repo's scripts/train_{objectnav,imagenav,
# pick_arm}_tpu.py at their widths), each run for RECIPE_UPDATES updates
RECIPE_PPO = dict(num_steps=64, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4)
RECIPE_UPDATES = 2  # cut from 3 for the script's time
ONAV_RECIPE = dict(num_scenes=16, episodes_per_scene=16, seed=0, extent=8.0, num_envs=128, max_episode_steps=200,
                   hw=64, hidden_size=192)
INAV_RECIPE = dict(num_scenes=8, episodes_per_scene=24, seed=0, extent=8.0, num_envs=128, max_episode_steps=200,
                   hw=64, hidden_size=192)
INAV_ENV = dict(num_envs=16, steps=4)  # [imagenav] (a): imagenav_procgen.yaml, then 4 steps without stop
ARM_RECIPE = dict(num_envs=128, task="pick", num_scenes=8, episodes_per_scene=16, seed=0, with_visual=False,
                  n_rooms_per_axis=1, n_clutter=0, max_episode_steps=120, control="arm")
# [pick-arm] (b): pick_procgen.yaml with ArmAction and BaseVelAction, the
# visual Gaussian policy of policy_from_config at N=32 (its defaults:
# resnet18, LSTM-512, 128x128 head cameras, contacts), 2 updates of T=32,
# then 8 deterministic episodes of at most ARM_EVAL["max_steps"] steps
ARM_OVERRIDES = ("habitat.task.actions.arm_action.type=ArmAction",
                 "habitat.task.actions.base_velocity.type=BaseVelAction")
ARM_VISUAL = dict(num_envs=32, updates=2, ppo=dict(num_steps=32, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4))
ARM_EVAL = dict(num_envs=8, max_steps=40)
NAV_OBS_ATOL = 1e-5  # card - CPU state sensors (tests/test_torch_env.py's bound)
GOAL_RGB_AGREE = 0.999  # goal RGB equal to the CPU's (tests/test_torch_raycast.py:188-189)
LOSS_RTOL = 1e-4  # card - CPU float32 update losses, relative to max(1, |loss|)
DDPPO_EXPERIMENT = "pointnav/ddppo_pointnav.yaml"
# [ddppo]: the recipe's N (the phase peaks at 72.5 GiB on the H100 when run
# alone) for 1 warm-up + 1 update (cut from 3 for the script's time limit)
DDPPO = dict(num_envs=64, updates=2)
# [ddppo-2rank]: a small resnet18 PointNav config, N=8 over 2 ranks of 4
DDPPO_2RANK = dict(num_envs=8, hw=64, hidden=128, ppo=dict(num_steps=8, ppo_epoch=2, num_mini_batch=2))
DDPPO_RTOL, DDPPO_ATOL = 2e-4, 2e-5  # 2 ranks vs 1 (the JAX package's sharded-vs-single test)
# [ppo-switches]: N=8, T=8, 64x64 depth; card vs CPU loss terms
SWITCH_ENV = dict(num_envs=8, hw=64, hidden=128, ppo=dict(num_steps=8, ppo_epoch=2, num_mini_batch=2))
SWITCH_RTOL = 1e-5
# [bc]: behavior cloning at the bench's widths (bench.py:29-52: 4 procedural
# scenes x 16 episodes, 128x128 depth + RGB + pointgoal, resnet18 base 32 /
# 16 groups, LSTM-512, bf16) at N=128 and BCConfig's T=32, so 4,096 frames
# per update (a bench PPO minibatch); a warm-up and BC_UPDATES timed updates
BC = dict(num_envs=128, num_steps=32)
BC_UPDATES = 3
# tests/test_il.py:14-38's learning gate: 30 updates of the blind clone from
# the JAX test's initial weights (habitat_torch/weights/bc_gate_init.pt,
# scripts/export_bc_gate_torch.py)
BC_GATE = dict(updates=30, rise=0.15, final=0.5, lr=2e-3)
BC_GATE_WEIGHTS = "habitat_torch/weights/bc_gate_init.pt"
# [bc]'s float32 update, card against CPU: the blind LSTM-512 pointgoal net
# at N=8 (no frame enters it, so the check sees the update, not the render)
BC_CHECK = dict(num_envs=8, hidden=512)
# [hrl]: scripts/train_hrl_tpu.py's configuration; a warm-up and
# HRL_UPDATES timed updates of HRL-PPO over the four oracle skills
HRL_ENV = dict(num_envs=128, task="rearrange", num_scenes=8, episodes_per_scene=16, seed=0, with_visual=False,
               n_rooms_per_axis=1, n_clutter=0, max_episode_steps=300)
HRL_PPO = dict(num_macro_steps=16, hl_interval=8, hidden_size=64)
HRL_UPDATES = 1
# the planner's and the fixed plan's rules (tests/test_hrl_planner.py:28-51,
# tests/test_hrl_pddl.py:59-71) on those tests' env (HRL_RULE_ENV): the share
# of envs with a successful episode within the steps given; at N=128 on
# [hrl]'s env (episodes of up to HRL_PLANNER_N128 steps, cut from 400 to keep
# the script near 1,000 s) the planner's rollout on the card and on the CPU,
# env by env
HRL_RULE_ENV = dict(num_envs=4, task="rearrange", with_visual=False, seed=3, max_episode_steps=400,
                    n_rooms_per_axis=1, n_clutter=0)
HRL_PLANNER = dict(steps=400, share=0.75)
HRL_FIXED = dict(steps=300, share=0.5)
HRL_PLANNER_N128 = 200
# card against CPU: a 100-step planner rollout and one HRL-PPO update at N=8
HRL_CHECK = dict(num_envs=8, steps=100, ppo=dict(num_macro_steps=4, hl_interval=8, hidden_size=64))
# the HRL experiment config ([hrl] (d)): pick_procgen.yaml + an HRL-PPO block,
# 2 updates of N=16
HRL_CONFIG_ENVS = 16
HRL_CONFIG_SKILLS = ("nav_to_obj", "pick", "nav_to_goal", "place")
# [vln]: scripts/train_vln_tpu.py's configuration (BC of the follower, 64x64
# depth, instruction + GPS + compass, resnet9 + LSTM-192, T=32, lr 1.5e-3)
VLN = dict(num_envs=128, num_scenes=8, episodes_per_scene=16, max_episode_steps=200, hw=64, hidden=192,
           num_steps=32, lr=1.5e-3)
VLN_UPDATES = 3  # timed updates after the warm-up one
# tests/test_eqa_vln.py::test_vln_seq2seq_il's rule: blind resnet18 + LSTM-128
VLN_RULE = dict(num_envs=4, num_scenes=1, episodes_per_scene=8, max_episode_steps=100, hidden=128, num_steps=16,
                lr=2e-3, updates=25)
# the float32 card-vs-CPU BC update: [vln]'s net, blind, at N=8, T=8
VLN_CHECK = dict(num_envs=8, num_scenes=1, episodes_per_scene=8, max_episode_steps=40, num_steps=8)
BC_LOSS_RTOL = 1e-5
# [eqa-il]: the three EQA imitation trainers through trainer_from_config
EQA_IL_TRAINERS = ("eqa-cnn-pretrain", "vqa", "pacman")
EQA_IL = dict(num_envs=128, updates=3)
# [eqa-referent]: scripts/train_eqa_referent_tpu.py's widths; its table cut
# from 4 x 4096 episodes to 4 x 256 for set-up time
EQA_REF = dict(num_envs=256, num_scenes=4, episodes_per_scene=256, max_episode_steps=6)
EQA_REF_PPO = dict(num_steps=12, num_mini_batch=2, ppo_epoch=2, lr=1e-3)
EQA_REF_UPDATES = 3
# [agents]: GoalFollower's open room (the flagship scenes' goals lie behind
# walls, where a straight-line follower stalls)
AGENT_ROOM = dict(num_scenes=1, episodes_per_scene=8, seed=91000, scene_kw={"n_rooms_per_axis": 1, "n_clutter": 0})
# [sim-api]: the single-env simulator on the card (generate_apartment(seed=0),
# its default 128x128 depth + RGB), walked by the ShortestPathFollower to a
# sampled goal as tests/test_env_api.py:120-138 walks it (seed 3, stop within
# 300 steps and 0.6 m), then a teleport with a rotation and 4
# velocity_control steps; a CPU TpuSim beside it takes the same actions
SIM_API = dict(seed=3, goal_radius=0.3, max_steps=300, reach=0.6, velocity_steps=4, dbv=(256, 256),
               sample_keys=4096, profile_steps=5)
SIM_TELEPORT = dict(action="teleport", action_args=dict(position=[3.0, 0.0, 3.0], rotation=[0.0, 0.29552, 0.0,
                                                                                              0.95534]))
SIM_VELOCITY = dict(action="velocity_control", action_args=dict(lin_vel=0.5, ang_vel=20.0, time_step=0.5))
# [obs-transforms]: the config store's widths (structured.py's cube_2_eq_base
# 256x512 from 256x256 faces, eq_2_cube_base 256, cube_2_fish_base 256) at
# N=32 on the bench's 4 procedural scenes, poses from the navigable-point
# sampler; test_projections.py's rows 16-48 of 64 and 4-pixel border of 32
# scale to rows 64-192 of 256 and a 32-pixel border of 256
OBS_TF = dict(num_envs=32, face=256, eq=(256, 512), fish=(256, 256), resize=128, reps=5, key_seed=21)
# [agents], stochastic: the flagship export as a PPOAgent(deterministic=False,
# seed=0) on the card beside the same agent on the CPU, driving the card env
AGENT_SAMPLED_STEPS = 40
# [env-api]: Benchmark episodes of pointnav_procgen.yaml; the mini on-disk
# dataset's episodes (all 8) under a step limit cut from the yaml's 500; the
# velocity path's envs, steps and envs auto-stopped at step 20
ENV_API = dict(bench_episodes=4, mini_episodes=8, mini_max_steps=200, vel_envs=128, vel_steps=32, vel_hw=128,
               vel_stops=16)
ENV_API_CONFIG = "benchmark/nav/pointnav/pointnav_procgen.yaml"
MINI_DATASET = ("habitat.dataset.type=PointNav-v1", "habitat.dataset.split=val",
                "habitat.dataset.data_path={root}/tests/assets/mini_dataset/pointnav/v1/{{split}}/{{split}}.json.gz",
                "habitat.dataset.scenes_dir={root}/tests/assets")
VEL_POS_ATOL = 1e-4  # card - CPU positions after one velocity step from the same state
# [social]: scripts/train_social_tpu.py's configurations
SOCIAL = dict(num_envs=128, num_scenes=8, episodes_per_scene=16, seed=0)
SOCIAL_MEASURES = ("nav_seek_success", "did_agents_collide", "found_human_rate")
SOCIAL_PPO = dict(single=dict(num_steps=64, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4),
                  vision=dict(num_steps=32, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4),
                  two=dict(num_steps=64, num_mini_batch=1, ppo_epoch=2, lr=2.5e-4))
SOCIAL_HW = (64, 64)  # (b)'s head camera
SOCIAL_UPDATES = 2  # timed updates after the warm-up one
SOCIAL_CHECK_STEPS = 32  # card steps each also taken on the CPU from the same state (cut from 64)
SOCIAL_ATOL = 1e-5  # + 1e-5 relative: card - CPU from the same state
SOCIAL_START_UPDATES = 4  # CPU float32 updates (N=16, T=16) before the card-vs-CPU update
SOCIAL_CHECK_ENVS = 32
# [hab3]: pick_procgen.yaml with two agents (tests/test_torch_hab3.py's HAB3 at the config's own size)
HAB3_OVERRIDES = ("habitat.simulator.agents.main_agent.articulated_agent_type=SpotRobot",
                  "habitat.simulator.agents.agent_1.articulated_agent_type=KinematicHumanoid",
                  "habitat.task.actions.agent_0_arm_action.type=ArmAction",
                  "habitat.task.actions.agent_0_base_velocity.type=BaseVelAction",
                  "habitat.task.actions.agent_1_oracle_nav_action.type=OracleNavAction",
                  "habitat.task.actions.agent_1_pddl_apply_action.type=PddlApplyAction",
                  "habitat.task.actions.agent_1_humanoidjoint_action.type=HumanoidJointAction",
                  "habitat.task.actions.agent_1_humanoid_pick_action.type=HumanoidPickAction",
                  "habitat.task.lab_sensors.multi_agent_all_predicates.type=MultiAgentGlobalPredicatesSensor")
HAB3_RULE_SIZE = ("habitat.dataset.procedural.num_scenes=1", "habitat.dataset.procedural.episodes_per_scene=4")
HAB3 = dict(num_envs=128, steps=16)  # scheduled steps, cut from 32 to keep the script near 1,000 s
# card - CPU from the same state under contacts: (atol, rtol) of the box
# fields and the robot force (tests/test_torch_rearrange_env.py's bounds)
HAB3_BOX_BOUND = dict(obj_pos=(6e-5, 0.0), obj_vel=(6e-4, 0.0), obj_quat=(1.2e-4, 0.0), obj_omega=(3e-3, 0.0),
                      accum_force=(1e-3, 1e-4), robot_force=(1e-3, 1e-4), articulated_agent_force=(1e-3, 1e-4))
# [art-scene]: scripts/train_more_tpu.py's open-task widths (N=128, 8 scenes x
# 16 episodes, 120 steps, one room per axis) with the generator's default 3
# clutter boxes (the recipe's 0 leaves no receptacle), receptacle goals,
# tests/test_samplers.py's AO-state sampler and art_objs, the URDF cabinet
ART_SCENE = dict(num_envs=128, num_scenes=8, episodes_per_scene=16, seed=0, n_rooms_per_axis=1, n_clutter=3,
                 max_episode_steps=120, render_size=(128, 128))
ART_URDF = "tests/assets/mini_dataset/urdf/kitchen_cabinet.urdf"
ART_URDF_OPEN = 0.42  # the cabinet's drawer travel (its upper limit)
ART_OPEN = dict(steps=200, state=0.36)  # tests/test_urdf_artobj.py's rule
ART_TIMED_STEPS = 64  # the opener runs on past its first opening to this many timed steps
ART_CHECK_STEPS = 32  # card steps each also taken on the CPU from the card's state
ART_VIEW_SHARE = 0.01  # the cabinet's pixels in the frame held to #3's plain version, at least
# [reach]: tests/test_rearrange.py::test_reach_task_trains_to_success's configuration
REACH_ENV = dict(num_envs=32, task="reach", with_visual=False, control="arm", n_rooms_per_axis=1, n_clutter=0,
                 max_episode_steps=40, seed=0)
REACH_PPO = dict(num_steps=16, num_mini_batch=2, ppo_epoch=2, lr=3e-4)
REACH_RULE = dict(updates=60, after=20, success=0.6, hidden=64)
REACH_GOALS = 4096  # episodes of the goal table held card against CPU
REACH_GOAL_ATOL = 1e-6  # resting EE + offset, card - CPU (the offsets themselves bit-equal)
RELATIONS = dict(num_envs=128, objects=8)  # the batched relations and predicates, card against CPU
# [vector-env]: workers, batched steps, the dataset cut per worker, the deadline for a forwarded error
VEC_ENV = dict(num_envs=4, steps=64, num_scenes=4, episodes_per_scene=4, error_s=30.0)
# [eval-video]: the flagship protocol's first scenes at N=8, one episode per env; the debug camera's peeks
EVAL_VIDEO = dict(num_envs=8, num_scenes=8, dbv=(128, 128),
                  peeks=("scene", {"center": [3.0, 0.5, 3.0], "size": [1.0, 1.0, 1.0]},
                         ([2.0, 0.0, 2.0], [4.0, 1.0, 4.0])))
# [clip]: one update per config; the envs whose features are held card against CPU
CLIP = dict(num_envs=16, num_steps=32, num_scenes=8, check_envs=4)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def cudnn_deterministic(on):
    """Within the block, cuDNN's deterministic algorithms where ``on``. TF32
    stays as set."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = before or on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(evt):
    """A profiler entry's own device time in microseconds (the attribute's
    name differs across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def share(mask):
    """The true share of a boolean tensor, counted in integers (a float32
    mean of millions of ones rounds)."""
    return int(mask.sum().item()) / max(mask.numel(), 1)


def agreement(name, got, ref):
    """Closest-hit agreement of (t, idx) pairs at the gates; returns (hit
    agreement, winner agreement, max |dt| on the same winner)."""
    (t_k, i_k), (t_p, i_p) = got, ref
    hit_k, hit_p = i_k >= 0, i_p >= 0
    hit_agree = share(hit_k == hit_p)
    both = hit_k & hit_p
    idx_agree = share(i_k[both] == i_p[both])
    same = both & (i_k == i_p)
    max_err = (t_k[same] - t_p[same]).abs().max().item()
    if not (hit_agree >= 0.9999 and idx_agree >= 0.999 and max_err < 5e-3):
        fail(f"{name}: hit {hit_agree} idx {idx_agree} |dt| {max_err}")
    return hit_agree, idx_agree, max_err


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes > t_ops else "operations")


def tensor_bytes(*xs):
    import torch

    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def test_flops(n_tests, n_inside=None):
    """FP32 operations of ``n_tests`` ray-triangle tests, of which
    ``n_inside`` are inside pairs (None: a kernel that completes every
    test)."""
    if n_inside is None:
        return n_tests * FLOPS_PER_RAY_TRI
    return n_tests * FLOPS_OUTSIDE + n_inside * (FLOPS_PER_RAY_TRI - FLOPS_OUTSIDE)


def compare_kernel(name, kernel, args, kwargs, n_tests, reps=50, plain_reps=3,
                   source="habitat_torch/csrc/raycast_fused.cu", plain_kwargs=None, flops_per_ray=FLOPS_PER_RAY,
                   n_inside=None):
    """Kernel vs its plain version on the same card inputs; times both and
    works out the bound from this call's inputs and the tests they need.
    ``n_tests`` and ``n_inside`` (see ``test_flops``) may be functions of
    the kernel's (t, idx), called after the plain version ran. With
    ``plain_reps=0`` the plain version runs once, timed as it is compared.
    ``flops_per_ray``: 0 where the ray features are an input."""
    import torch

    before = kernel.launches
    t_k, i_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{name}: wrapper did not launch its kernel")
    t0 = time.perf_counter()
    t_p, i_p = kernel.plain(*args, **kwargs, **(plain_kwargs or {}))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hit_agree, idx_agree, max_err = agreement(name, (t_k, i_k), (t_p, i_p))
    ms = cuda_ms(lambda: kernel(*args, **kwargs), reps)
    if plain_reps:
        plain_ms = cuda_ms(lambda: kernel.plain(*args, **kwargs), plain_reps, warmup=1)
    if callable(n_tests):
        n_tests = n_tests(t_k, i_k)
    if callable(n_inside):
        n_inside = n_inside(t_k, i_k)
    n_rays = t_k.numel()
    bytes_moved = tensor_bytes(*args) + 8 * n_rays
    row = dict(
        name=name, route="cuda", source=source,
        max_abs_err=max_err, hit_agree=hit_agree, idx_agree=idx_agree,
        ms=ms, plain_ms=plain_ms,
        **bound(bytes_moved, test_flops(n_tests, n_inside) + n_rays * flops_per_ray),
        library_ms=None, ray_tri_tests=n_tests, tests_per_s=n_tests / (ms * 1e-3), inside_pairs=n_inside,
        hit_fraction=(i_k >= 0).float().mean().item(),
        # rays whose plain (no early stop) hit is nearer than the kernel's
        nearer_in_plain_rays=int(((i_k != i_p) & (t_p < t_k)).sum().item()),
        # rays whose t or winner differs from the plain version's
        rays_differing=int(((t_k != t_p) | (i_k != i_p)).sum().item()),
    )
    if n_inside is not None:  # the bound of a kernel that completes every test
        row["bound_old_rule_ms"] = bound(bytes_moved, test_flops(n_tests) + n_rays * flops_per_ray)["bound_ms"]
    return row


def ring_row(name, kernel, args, kwargs, n_tests, design, tile_width, **kw):
    """``compare_kernel`` for a ring kernel (csrc/closest_hit_ring.cuh): its
    bound counts the whole test only for the plain version's inside pairs,
    and the row carries the kernel's design, which must match the wrappers'
    constants."""
    import torch
    from habitat_torch.ops import raycast_kernels as rk

    tested = {}
    row = compare_kernel(name, kernel, args, kwargs, n_tests, plain_kwargs=dict(tested=tested),
                         n_inside=lambda t, i: tested["inside"], **kw)
    row["design"] = kernel_design(name, design, rk.RING_BLOCK_RAYS, rk.RING_STAGES, tile_width=tile_width)
    torch.cuda.empty_cache()
    return row


def ring_text(r):
    """A ring kernel's rate, inside pairs, bounds and design, for its
    [kernel] line."""
    return (f"{r['tests_per_s']:.4g} tests/s, {r['inside_pairs']} inside pairs of {r['ray_tri_tests']} tests; "
            f"bound {r['bound_ms']:.4f} ms (restated rule; {r['bound_ms'] / r['ms']:.3f} of the kernel's time), "
            f"{r['bound_old_rule_ms']:.4f} ms by the old rule; {design_text(r['design'])}")


def rate_text(r):
    """A bytes-bound kernel's achieved rate and share of its bound, for its
    [kernel] line (the row's "bytes" key: what the bound counts)."""
    r["tb_per_s"] = r["bytes"] / (r["ms"] * 1e-3) / 1e12
    return (f"{r['bytes'] / 1e6:.1f} MB at {r['tb_per_s']:.3f} TB/s; bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.3f} of the kernel's time")


def render_split(pose, kw, reps, warmup=2):
    """One render's time, and its stages each timed on its own with CUDA
    events: the closest-hit call (selection, rays and features), the kernel,
    and the epilogue from the kernel's outputs to the frames. Returns (the
    times in ms, the kernel's (wrapper, args, kwargs))."""
    from habitat_torch.ops import raycast as rc

    render = cuda_ms(lambda: rc.render_batch(*pose, **kw), reps, warmup)
    select = cuda_ms(lambda: rc.closest_hit_call(*pose, **kw), reps, warmup)
    kernel, args, kwargs, rays = rc.closest_hit_call(*pose, **kw)
    kernel_ms = cuda_ms(lambda: kernel(*args, **kwargs), reps, warmup)
    hits = kernel(*args, **kwargs)
    epilogue = cuda_ms(lambda: rc.render_epilogue(*pose, hits, rays, **kw), reps, warmup)
    return (dict(render=render, select=select, kernel=kernel_ms, epilogue=epilogue,
                 stages=select + kernel_ms + epilogue), (kernel, args, kwargs))


def split_text(sp, select="select"):
    return (f"render {sp['render']:.3f} ms; stages timed one by one: {select} {sp['select']:.3f} + kernel "
            f"{sp['kernel']:.3f} + epilogue {sp['epilogue']:.3f} = {sp['stages']:.3f}")


def compare_culled(kernel, args, kwargs, source, reps=5, attr_dim=1):
    """A culled kernel against its plain version on the same card inputs
    (it returns the winner's attributes, not its index; ``attr_dim`` is
    their axis): hit/miss agreement >= 0.9999, all 8 attributes equal on >=
    0.999 of common hits, |dt| < 5e-3 m where they are equal. Every listed
    chunk is tested by every ray of its tile, so the bound counts N * R * K
    * C tests and the plain version's inside pairs. Returns (row, the
    kernel's (t, attrs))."""
    import torch

    name = kernel.__name__
    before = kernel.launches
    t_k, a_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{name}: wrapper did not launch its kernel")
    tested = {}
    t0 = time.perf_counter()
    t_p, a_p = kernel.plain(*args, **kwargs, tested=tested)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hit_k, hit_p = a_k.select(attr_dim, 7) > 0.5, a_p.select(attr_dim, 7) > 0.5
    hit_agree = share(hit_k == hit_p)
    both = hit_k & hit_p
    same = both & (a_k == a_p).all(attr_dim)
    attr_agree = share(same[both])
    max_err = (t_k[same] - t_p[same]).abs().max().item()
    if not (hit_agree >= 0.9999 and attr_agree >= 0.999 and max_err < 5e-3):
        fail(f"{name}: hit {hit_agree} attributes {attr_agree} |dt| {max_err}")
    ms = cuda_ms(lambda: kernel(*args, **kwargs), reps)
    N, nt, K = args[2].shape
    n_rays = t_k.numel()
    n_tests = n_rays * K * kwargs["tri_chunk"]
    bytes_moved = tensor_bytes(*args, *kwargs.values()) + (4 + 32) * n_rays
    return dict(
        name=name, route="cuda", source=source,
        max_abs_err=max_err, hit_agree=hit_agree, attr_agree=attr_agree, ms=ms, plain_ms=plain_ms,
        **bound(bytes_moved, test_flops(n_tests, tested["inside"])),
        library_ms=None, ray_tri_tests=n_tests, inside_pairs=tested["inside"], hit_fraction=share(hit_k), list_slots=K,
        tri_chunk=kwargs["tri_chunk"],
    ), (t_k, a_k)


def compare_tilecull(kernel, args, kwargs, n_tests, reps=50):
    """The tile-cull kernel against its plain version on the same card
    inputs: hit/miss (row 11) agreement >= 0.9999, the winner (gid, row 6)
    on >= 0.999 of common hits, all 16 rows within 1e-5 on >= 0.999 of the
    rays whose winner (or miss) is the same, |dt| < 5e-3 m there, and row
    12 = 0.35 on every miss; on the ring loop also t and all
    16 rows equal on every ray. Its bound is #1's (the whole test only for
    the plain version's inside pairs) plus the epilogue's operations and its
    68 B per ray. Returns (row, the kernel's (t, attrs))."""
    import torch
    from habitat_torch.ops import raycast_kernels as rk

    before = kernel.launches
    t_k, a_k = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail("raycast_tilecull_t: wrapper did not launch its kernel")
    t_p, a_p = kernel.plain(*args, **kwargs)
    N, nt, _, rt = a_k.shape
    hit_k, hit_p = a_k[:, :, 11] > 0.5, a_p[:, :, 11] > 0.5  # (N, nt, rt)
    gid_k, gid_p = a_k[:, :, 6], a_p[:, :, 6]
    hit_agree = share(hit_k == hit_p)
    both = hit_k & hit_p
    idx_agree = share(gid_k[both] == gid_p[both])
    same = (hit_k == hit_p) & (gid_k == gid_p)
    rows_err = (a_k - a_p).abs().amax(2)[same]
    rows_agree = share(rows_err <= 1e-5)
    t_err = (t_k.reshape(N, nt, rt) - t_p.reshape(N, nt, rt))[same & hit_k].abs().max().item()
    miss_shade = bool((a_k[:, :, 12][~hit_k] == 0.35).all().item())
    if not (hit_agree >= 0.9999 and idx_agree >= 0.999 and rows_agree >= 0.999 and t_err < 5e-3 and miss_shade):
        fail(f"raycast_tilecull_t: hit {hit_agree} gid {idx_agree} rows {rows_agree} |dt| {t_err} "
             f"miss shade 0.35 {miss_shade}")
    rays_differing = int(((t_k.reshape(N, nt, rt) != t_p.reshape(N, nt, rt)) | (a_k != a_p).any(2)).sum().item())
    if rays_differing:
        fail(f"raycast_tilecull_t: {rays_differing} rays differ from the plain version in t or a row")
    tested = {}
    gm, _, ids, cnt, sids, d_t, Bt = args
    rk.raycast_fused_sel_t.plain(gm, sids, ids, cnt, d_t, Bt, **kwargs, tested=tested)
    n_rays = t_k.numel()
    flops = test_flops(n_tests, tested["inside"]) + n_rays * (FLOPS_PER_RAY + FLOPS_TILECULL_EPILOGUE)
    bytes_moved = tensor_bytes(*args) + (4 + 64) * n_rays
    row = dict(
        name="raycast_tilecull_t", route="cuda", source="habitat_torch/csrc/raycast_fused.cu",
        replaces="habitat_tpu/ops/raycast_pallas.py:856", max_abs_err=max(t_err, rows_err.max().item()),
        hit_agree=hit_agree, idx_agree=idx_agree, rows_agree=rows_agree, miss_shade=0.35 if miss_shade else None,
        rays_differing=rays_differing,
        ms=cuda_ms(lambda: kernel(*args, **kwargs), reps),
        plain_ms=cuda_ms(lambda: kernel.plain(*args, **kwargs), 3, warmup=1),
        **bound(bytes_moved, flops),
        library_ms=None, ray_tri_tests=n_tests, inside_pairs=tested["inside"], hit_fraction=share(hit_k),
        survivor_chunks_mean=args[3].float().mean().item(),
        # the bound by the old rule: every test whole, no epilogue operations
        bound_old_rule_ms=bound(bytes_moved, n_tests * FLOPS_PER_RAY_TRI + n_rays * FLOPS_PER_RAY)["bound_ms"],
    )
    row["tests_per_s"] = n_tests / (row["ms"] * 1e-3)
    return row, (t_k, a_k)


def kernel_design(name, design, block_rays, stages, warp_rays=None, tile_width=32):
    """A kernel's design as its library reports it (``rk.stream_design`` or
    ``rk.culled_design``), checked against the constants the wrappers and
    the plain versions' counters assume; adds the pixel rows a block covers
    in tiles ``tile_width`` pixels wide."""
    want = dict(rays_per_block=block_rays, ring_stages=stages, spill_bytes=0)
    if warp_rays is not None:
        want["rays_per_warp"] = warp_rays
    got = {k: design[k] for k in want}
    if got != want:
        fail(f"{name}: the kernel's design {design} is not the wrappers' {want}")
    return dict(design, pixel_rows_per_block=block_rays // tile_width)


def design_text(d):
    return (f"{d['rays_per_thread']} rays per thread, {d['rays_per_block']} rays ({d['pixel_rows_per_block']} pixel "
            f"rows) per block, ring of {d['ring_stages']}, {d['registers']} registers, {d['spill_bytes']} B spilled, "
            f"{d['static_smem_bytes'] + d['dynamic_smem_bytes']} B shared memory, {d['blocks_per_sm']} blocks per SM")


def needed_tests(ids, cnt, t, tri_chunk, ray_tile):
    """Ray-triangle tests that a nearest-first list leaves to do given each
    ray's final hit: the listed chunks whose dmin lies below the ray's t
    (all of them for a miss), times the chunk size."""
    import torch

    N, nt, K = ids.shape
    dmin = (ids >> 18).float() * 1e-2
    pos = torch.arange(K, device=ids.device)
    dmin = torch.where(pos < cnt[..., None], dmin, float("inf"))  # the tail is padding
    need = torch.searchsorted(dmin, t.reshape(N, nt, ray_tile).contiguous())  # slots with dmin < t
    return int(need.sum().item()) * tri_chunk


def update_data(start, env_c, env_g, upd):
    """The rollout batch (seed 5) of a policy with weights ``start`` on the
    card, on the card and on the CPU."""
    import torch

    from habitat_torch.baselines.ppo import PPOLearner
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    net = make_pointnav_resnet_policy(4)
    net.load_state_dict(start)
    lrn = PPOLearner(env_g, net, upd)
    _, gbatch, glast, gh0, _ = lrn.collect_rollout(lrn.init(seed=5))
    on_cpu = dict(env=env_c, batch=gbatch._replace(
        obs={k: v.cpu() for k, v in gbatch.obs.items()},
        **{f: getattr(gbatch, f).cpu() for f in gbatch._fields if f != "obs"}), last=glast.cpu(), h0=gh0.cpu())
    return dict(cpu=on_cpu, card=dict(env=env_g, batch=gbatch, last=glast, h0=gh0))


def one_update(dtype, device, start, data, upd, deterministic=False, **patch):
    """The update from ``start`` on the rollout batch ``data``, with the
    policy in ``dtype`` on ``device`` (``ops.pool`` functions patched as
    given; ``deterministic``: cuDNN's deterministic algorithms): its losses
    and each trained tensor's change."""
    import torch

    from habitat_torch.baselines.ppo import PPOLearner
    from habitat_torch.models.policy import make_pointnav_resnet_policy
    from habitat_torch.ops import pool

    d = data["cpu" if torch.device(device).type == "cpu" else "card"]
    net = make_pointnav_resnet_policy(4, dtype=dtype, device=device)
    net.load_state_dict(start)
    lrn = PPOLearner(d["env"], net, upd)
    with (mock.patch.multiple(pool, **patch) if patch else contextlib.nullcontext()), \
            cudnn_deterministic(deterministic):
        m = lrn.update(torch.Generator(device=device).manual_seed(0), d["batch"], d["last"], d["h0"])
    return ({k: v.item() for k, v in m.items() if k.startswith("losses/")},
            {k: p.detach().cpu() - start[k] for k, p in net.named_parameters() if p.requires_grad})


def per_tensor(da, db, lr):
    """Per trained tensor: the share of elements whose two changes agree
    within lr/10, and whether it changed on both sides."""
    return {k: (share((da[k] - db[k]).abs() <= lr / 10), bool(da[k].any() and db[k].any())) for k in da}


def check_start(env_c, upd, seed):
    """A float32 [check] start, the same in every run: the policy of ``seed``
    after CHECK_CPU_STEPS float32 train steps of the CPU env ``env_c`` (CPU
    kernels' plain versions, CHECK_THREADS threads), as bf16 weights."""
    import torch

    from habitat_torch.baselines.ppo import PPOLearner
    from habitat_torch.models.policy import make_pointnav_resnet_policy

    threads = torch.get_num_threads()
    torch.set_num_threads(CHECK_THREADS)
    torch.manual_seed(seed)
    net = make_pointnav_resnet_policy(4, dtype=torch.float32, device="cpu")
    lrn = PPOLearner(env_c, net, upd)
    rs = lrn.init(seed=seed)
    for _ in range(CHECK_CPU_STEPS):
        rs, _ = lrn.train_step(rs)
    torch.set_num_threads(threads)
    deployed = make_pointnav_resnet_policy(4, device="cpu")
    deployed.load_state_dict(net.state_dict())
    return deployed.state_dict()


def device_time_and_launches(fn):
    """fn() once under torch.profiler: (fn's result, device kernel ms, kernel
    launches, the kernels sorted by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev_kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA and device_us(e) > 0]
    dev_kernels.sort(key=device_us, reverse=True)
    return out, sum(device_us(e) for e in dev_kernels) / 1e3, sum(e.count for e in dev_kernels), dev_kernels


def held_to_float64(tag, name, card, cpu32, cpu64, atol, rtol=0.0):
    """One call's output on the card against the same call in float32 and in
    float64 on the CPU: the card's largest error against float64 within
    atol (+ rtol of the largest |float64| value) plus twice the CPU float32
    error. Returns the gaps for the log."""
    err_card = (card.double().cpu() - cpu64).abs().max().item()
    err_cpu = (cpu32.double() - cpu64).abs().max().item()
    gap = (card.cpu() - cpu32).abs().max().item()
    allowed = atol + rtol * cpu64.abs().max().item() + 2 * err_cpu
    if not err_card <= allowed:
        fail(f"[{tag}] {name}: card error {err_card:.3g} against float64, allowed {allowed:.3g} "
             f"(CPU float32 error {err_cpu:.3g}; card - CPU {gap:.3g})")
    return dict(gap=gap, err_card=err_card, err_cpu=err_cpu)


def contacts_scene(seed=0):
    """The [contacts] episode's start, seeded, float32 numpy: N envs of O
    boxes with half-extents 0.05-0.20 m, floors at -0.1..0.1 m, a third of
    the boxes floating up to 0.4 m, a third tipped 10-40 degrees, spawns
    overlapping where they fall together, one box in 10 envs held, and the
    robot's path: across the boxes in CONTACTS["robot_steps"] steps, then
    parked far off."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N, O = CONTACTS["num_envs"], CONTACTS["objects"]
    half = rng.uniform(0.05, 0.20, (N, O, 3))
    floor = rng.uniform(-0.1, 0.1, N)
    lift = np.where(rng.uniform(size=(N, O)) < 1 / 3, rng.uniform(0.0, 0.4, (N, O)), 0.0)
    pos = np.stack([rng.uniform(-0.5, 0.5, (N, O)), floor[:, None] + lift, rng.uniform(-0.3, 0.3, (N, O))], -1)
    yaw = rng.uniform(-np.pi, np.pi, (N, O))
    tilt = np.where(rng.uniform(size=(N, O)) < 1 / 3, np.deg2rad(rng.uniform(10, 40, (N, O))), 0.0)
    phi = rng.uniform(0, 2 * np.pi, (N, O))  # the tilt axis, horizontal
    q_yaw = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2), 0 * yaw], -1)
    q_tilt = np.stack([np.cos(tilt / 2), np.sin(tilt / 2) * np.cos(phi), 0 * tilt, np.sin(tilt / 2) * np.sin(phi)], -1)
    w1, x1, y1, z1 = np.moveaxis(q_tilt, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q_yaw, -1, 0)
    quat = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    free = np.ones((N, O), bool)
    free[rng.uniform(size=N) < 0.1, 0] = False
    steps, rs = CONTACTS["steps"], CONTACTS["robot_steps"]
    x = np.where(np.arange(steps) < rs, -1.5 + 3.0 * np.arange(steps) / rs, 50.0)
    z0 = rng.uniform(-0.2, 0.2, N)
    agent = np.stack([np.broadcast_to(x[:, None], (steps, N)), np.broadcast_to(floor, (steps, N)),
                      np.broadcast_to(z0, (steps, N))], -1)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return dict(p=f32(pos), v=np.zeros((N, O, 3), np.float32), q=f32(quat), w=np.zeros((N, O, 3), np.float32),
                free=free, floor=f32(floor), half=f32(half), agent=f32(agent))


def box_shares(p, q, w_, v, free, floor, half):
    """(share of free boxes asleep, share tipped, the lowest corner's largest
    sink below its floor) of a contacts-v6 state, CPU tensors."""
    import torch

    from habitat_torch.tasks.rearrange import rigid_body as rigid

    R = rigid.quat_to_matrix(q)
    asleep = (v == 0).all(-1) & (w_ == 0).all(-1)
    tipped = R[..., 1, 1] < 0.9
    centre = p + torch.stack([torch.zeros_like(half[..., 1]), half[..., 1], torch.zeros_like(half[..., 1])], -1)
    corners = centre.unsqueeze(-2) + (R.unsqueeze(-3) @ (rigid.corner_signs(p) * half.unsqueeze(-2)).unsqueeze(-1)
                                      ).squeeze(-1)
    sink = (floor[:, None] - corners[..., 1].amin(-1))[free].max().item()
    n = int(free.sum())
    return int((asleep & free).sum()) / n, int((tipped & free).sum()) / n, sink


def no_host_sync(tag, what, fn):
    """fn()'s result; fails unless fn() runs under
    torch.cuda.set_sync_debug_mode("error")."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"[{tag}] {what} synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def contacts_phase(gpu, dev):
    """[contacts]: settle_objects at E=128 x O=3, then the v6 contact step
    over CONTACTS["steps"] steps on ``dev``: ms per step, launches per step, the
    device's idle share, and the gates against the CPU."""
    import numpy as np
    import torch

    from habitat_torch.tasks.rearrange import rearrange_env as renv
    from habitat_torch.tasks.rearrange.generator import settle_objects

    t_phase = time.perf_counter()
    sc = contacts_scene(0)
    N, O, steps = CONTACTS["num_envs"], CONTACTS["objects"], CONTACTS["steps"]

    # settling: every spawn upright, as the generator settles them (v3)
    settled = settle_objects(sc["p"], sc["free"], sc["floor"], steps=CONTACTS["settle_steps"], device=dev)
    t0 = time.perf_counter()
    settle_objects(sc["p"], sc["free"], sc["floor"], steps=CONTACTS["settle_steps"], device=dev)
    settle_s = time.perf_counter() - t0  # numpy out: the call ends synchronised
    sink = (sc["floor"][:, None] - settled[..., 1])[sc["free"]].max()
    if not (np.isfinite(settled).all() and sink <= 1e-6):
        fail(f"[contacts] settle_objects left a valid box {sink:.3g} m below its floor")
    log(f"[contacts] {gpu}: settle_objects E={N} x O={O}, {CONTACTS['settle_steps']} v3 steps: {settle_s * 1e3:.1f} ms "
        f"({settle_s * 1e3 / CONTACTS['settle_steps']:.2f} ms per step); every valid box on or above its floor "
        f"(lowest {-sink:.2e} m above)")

    cpu = {k: torch.as_tensor(x) for k, x in sc.items()}
    card = {k: x.to(dev) for k, x in cpu.items()}
    kw = dict(dt=CONTACTS["dt"], n_substeps=CONTACTS["substeps"])

    def step(st, c, s):
        p, v, f, q, w = renv.contact_step(st[0], st[1], c["free"], c["floor"], c["agent"][s], half=c["half"],
                                          quat=st[2], omega=st[3], **kw)
        return (p, v, q, w), f

    def episode(c, n=steps, keep=(), windows=1):
        """n steps from the start; the states at the steps in ``keep``, and
        the wall of each of ``windows`` equal runs of consecutive steps."""
        st = (c["p"], c["v"], c["q"], c["w"])
        kept, force, walls = {}, torch.zeros(N, device=c["p"].device), []
        for s in range(n):
            if s % (n // windows) == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if s in keep:
                kept[s] = st
            st, f = step(st, c, s)
            force = force + f
            if (s + 1) % (n // windows) == 0:
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        return st, force, kept, walls

    episode(card, n=CONTACTS["warmup"])
    # the episode, timed in CONTACTS["runs"] runs of consecutive steps
    card_end, card_force, kept, walls = episode(card, keep=(0, 30), windows=CONTACTS["runs"])
    ms = sorted(w * 1e3 * CONTACTS["runs"] / steps for w in walls)
    no_host_sync("contacts", "contact_step", lambda: step(kept[30], card, 30))
    n_prof = CONTACTS["profile_steps"]
    t0 = time.perf_counter()
    _, dev_ms, launches, top = device_time_and_launches(lambda: episode(card, n=n_prof))
    prof_s = time.perf_counter() - t0
    idle = 1 - dev_ms / (ms[len(ms) // 2] * n_prof)
    log(f"[contacts] {gpu}: contact_step v6 N={N} O={O} dt={kw['dt']} x{kw['n_substeps']} substeps: ms per step "
        f"median {ms[len(ms) // 2]:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}) over the {steps}-step episode's "
        f"{CONTACTS['runs']} runs of {steps // CONTACTS['runs']} steps; {launches / n_prof:.0f} launches per step, "
        f"device {dev_ms / n_prof:.3f} ms per step, idle share {idle:.3f} ({n_prof} profiled steps against the "
        f"median; profiling took {prof_s:.1f} s); no host sync in a step")
    for e in top[:5]:
        log(f"[contacts]   {device_us(e) / 1e3 / n_prof:8.4f} ms/step {e.count // n_prof:5d}x  {e.key[:80]}")

    # gate 1: one call from the same state, card against the CPU
    one = {}
    for s, st in kept.items():
        st32 = tuple(x.cpu() for x in st)
        ref32, f32 = step(st32, cpu, s)
        c64 = {k: (x.double() if x.is_floating_point() else x) for k, x in cpu.items()}
        ref64, f64 = step(tuple(x.double() for x in st32), c64, s)
        got, fg = step(st, card, s)
        for name, g, r32, r64 in zip("pvqw", got, ref32, ref64):
            one[(s, name)] = held_to_float64(
                "contacts", f"step {s} {name}", g, r32, r64, PHYS_ATOL, PHYS_W_RTOL if name == "w" else 0.0)
        one[(s, "force")] = held_to_float64("contacts", f"step {s} force", fg, f32, f64, FORCE_ATOL, FORCE_RTOL)
        one[(s, "force")]["rel"] = one[(s, "force")]["gap"] / max(f32.abs().max().item(), 1e-12)
    log("[contacts] one step card vs CPU from the same state: " + "; ".join(
        f"step {s}: " + ", ".join(f"|d{k}| {one[(s, k)]['gap']:.2e}" for k in "pvqw")
        + f", force rel {one[(s, 'force')]['rel']:.2e}" for s in kept)
        + " (each within its float64 gate)")

    # gate 2: the episode on the CPU from the same start
    t0 = time.perf_counter()
    cpu_end, cpu_force, _, _ = episode(cpu)
    cpu_s = time.perf_counter() - t0
    shares = {}
    for tag, (p, v, q, w_) in (("card", card_end), ("cpu", cpu_end)):
        p, v, q, w_ = (x.cpu() for x in (p, v, q, w_))
        if not all(torch.isfinite(x).all() for x in (p, v, q, w_)):
            fail(f"[contacts] non-finite {tag} state after {steps} steps")
        shares[tag] = box_shares(p, q, w_, v, cpu["free"], cpu["floor"], cpu["half"])
    (a_c, t_c, s_c), (a_p, t_p, s_p) = shares["card"], shares["cpu"]
    log(f"[contacts] after {steps} steps: asleep {a_c:.4f} card / {a_p:.4f} CPU, tipped {t_c:.4f} / {t_p:.4f}, "
        f"deepest corner below its floor {s_c * 1e3:.2f} / {s_p * 1e3:.2f} mm, robot force summed over the episode "
        f"{card_force.sum().item():.1f} / {cpu_force.sum().item():.1f}; the CPU episode took {cpu_s:.1f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not (abs(a_c - a_p) <= SHARE_GAP and abs(t_c - t_p) <= SHARE_GAP and max(s_c, s_p) <= FLOOR_SINK):
        fail(f"[contacts] shares card {shares['card']} against CPU {shares['cpu']}: gap above {SHARE_GAP} "
             f"or a corner deeper than {FLOOR_SINK} m")


def arm_phase(gpu, dev):
    """[arm]: Fetch's step_arm and IK at N=128 on ``dev``: ms per call,
    launches per call, no host sync in step_arm, and the gates against the
    CPU."""
    import numpy as np
    import torch

    from habitat_torch.articulated_agents import dynamics as arm_dyn
    from habitat_torch.articulated_agents import kinematics as kin
    from habitat_torch.articulated_agents.params import FETCH

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    N = ARM["num_envs"]
    lo, hi = np.array(FETCH.joint_limits_lower), np.array(FETCH.joint_limits_upper)
    rest = np.array(FETCH.resting_pose)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    q0 = f32(np.clip(rest + rng.normal(0, 0.3, (N, 7)), lo, hi))
    target = f32(np.clip(rest + rng.normal(0, 0.4, (N, 7)), lo + 0.05, hi - 0.05))
    qd0 = torch.zeros(N, 7)
    dyn = arm_dyn.default_arm_dynamics(FETCH, kp=ARM["kp"], kd=ARM["kd"], device=dev)
    dyn_cpu = arm_dyn.default_arm_dynamics(FETCH, kp=ARM["kp"], kd=ARM["kd"], device="cpu")
    dyn64 = arm_dyn.ArmDynParams(*(x.double() for x in dyn_cpu[:5]), armature=dyn_cpu.armature)
    kw = dict(dt=ARM["dt"], substeps=ARM["substeps"])
    tc = target.to(dev)

    def run(q, qd, n, keep=(), windows=1):
        kept, walls = {}, []
        for s in range(n):
            if s % (n // windows) == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if s in keep:
                kept[s] = (q, qd)
            q, qd = arm_dyn.step_arm(FETCH, dyn, q, qd, tc, **kw)
            if (s + 1) % (n // windows) == 0:
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        return q, qd, kept, walls

    run(q0.to(dev), qd0.to(dev), ARM["warmup"])
    q_end, qd_end, kept, walls = run(q0.to(dev), qd0.to(dev), ARM["steps"], keep=(0, 1, 10, 100, 299),
                                     windows=ARM["runs"])
    ms = sorted(w * 1e3 * ARM["runs"] / ARM["steps"] for w in walls)
    _, dev_ms, launches, _ = device_time_and_launches(lambda: arm_dyn.step_arm(FETCH, dyn, q_end, qd_end, tc, **kw))
    no_host_sync("arm", "step_arm", lambda: arm_dyn.step_arm(FETCH, dyn, q_end, qd_end, tc, **kw))
    gaps = {}
    for s, (q, qd) in kept.items():
        gq, gqd = arm_dyn.step_arm(FETCH, dyn, q, qd, tc, **kw)
        rq, rqd = arm_dyn.step_arm(FETCH, dyn_cpu, q.cpu(), qd.cpu(), target, **kw)
        eq, eqd = arm_dyn.step_arm(FETCH, dyn64, q.cpu().double(), qd.cpu().double(), target.double(), **kw)
        gaps[s] = (held_to_float64("arm", f"call {s} q", gq, rq, eq, PHYS_ATOL),
                   held_to_float64("arm", f"call {s} qd", gqd, rqd, eqd, PHYS_ATOL, PHYS_W_RTOL))
    track = (q_end.cpu() - target).abs().max().item()
    log(f"[arm] {gpu}: step_arm Fetch N={N} dt=1/30 x{ARM['substeps']} substeps: ms per call median "
        f"{ms[len(ms) // 2]:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}) over the {ARM['steps']} calls' {ARM['runs']} runs "
        f"of {ARM['steps'] // ARM['runs']}; "
        f"{launches} launches per call, device {dev_ms:.3f} ms per call; no host sync in a call; card vs CPU per call "
        f"max |dq| {max(g[0]['gap'] for g in gaps.values()):.2e}, |dqd| {max(g[1]['gap'] for g in gaps.values()):.2e} "
        f"(float64 gates met); tracking after {ARM['steps']} calls {track:.4f} rad, |qd| "
        f"{qd_end.abs().max().item():.4f} rad/s")
    if not track <= ARM_TRACK:
        fail(f"[arm] the PD motors left a joint {track} rad from its target")

    # IK toward reachable targets near the resting pose, from the resting pose
    goal = f32(np.clip(rest + rng.normal(0, 0.3, (N, 7)), lo, hi))
    ee_goal = kin.ee_position(FETCH, goal)
    start = f32(np.broadcast_to(rest, (N, 7)))
    ik_kw = dict(iters=ARM["ik_iters"])
    ee_c, start_c = ee_goal.to(dev), start.to(dev)
    kin.ik_solve(FETCH, ee_c, start_c, **ik_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ARM["ik_reps"]):
        got = kin.ik_solve(FETCH, ee_c, start_c, **ik_kw)
    torch.cuda.synchronize()
    ik_ms = (time.perf_counter() - t0) * 1e3 / ARM["ik_reps"]
    _, ik_dev_ms, ik_launches, _ = device_time_and_launches(lambda: kin.ik_solve(FETCH, ee_c, start_c, **ik_kw))
    ref = kin.ik_solve(FETCH, ee_goal, start, **ik_kw)
    ref64 = kin.ik_solve(FETCH, ee_goal.double(), start.double(), **ik_kw)
    g = held_to_float64("arm", "ik_solve q", got, ref, ref64, PHYS_ATOL)
    err = kin.ik_error(FETCH, ee_goal, got.cpu()).sort().values
    med, worst = err[N // 2].item(), err[-1].item()
    log(f"[arm] {gpu}: ik_solve Fetch N={N} iters={ARM['ik_iters']}: {ik_ms:.3f} ms per call, {ik_launches} launches "
        f"(device {ik_dev_ms:.3f} ms); card vs CPU max |dq| {g['gap']:.2e}; final error median {med * 1e3:.2f} mm, "
        f"max {worst * 1e3:.2f} mm; the phase {time.perf_counter() - t_phase:.1f} s")
    if not (med <= IK_MEDIAN_ERR and worst <= IK_MAX_ERR):
        fail(f"[arm] IK error median {med} max {worst} against {IK_MEDIAN_ERR} / {IK_MAX_ERR}")


def greedy_pick(obs):
    """The scripted greedy controller of tests/test_rearrange.py:53-73 on card
    tensors: turn toward the pick target, drive, grab within 0.7 m."""
    import torch

    from habitat_torch.tasks.rearrange import rearrange_env as renv

    rel = obs["obj_start_sensor"]
    dist = torch.sqrt(rel[:, 0] ** 2 + rel[:, 2] ** 2)
    ang = torch.atan2(-rel[:, 0], -rel[:, 2])
    act = torch.where(ang.abs() < 0.20943951, renv.A_FWD, torch.where(ang > 0, renv.A_LEFT, renv.A_RIGHT))
    return torch.where(dist < 0.7, renv.A_GRAB, act).to(torch.int32)


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (fn's result, the
    number of synchronising CUDA calls it made, where in the port each was
    made)."""
    import traceback
    import warnings

    import torch

    sites = []

    def record(message, *args, **kwargs):
        if "called a synchronizing" in str(message):
            port = [f for f in traceback.extract_stack() if "habitat_torch" in f.filename]
            sites.append(f"{os.path.relpath(port[-1].filename, ROOT)}:{port[-1].lineno}" if port else "?")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, len(sites), ", ".join(sites)


def env_like(env, device, idx=None, with_visual=None):
    """A RearrangeBatchedEnv with ``env``'s pack, table and settings on
    ``device``: the envs ``idx`` of its episode order (all by default), with
    the head camera unless ``with_visual=False``."""
    from habitat_torch.tasks.rearrange.rearrange_env import RearrangeBatchedEnv

    order = env.order if idx is None else env.order[idx.to(env.order.device)]
    return RearrangeBatchedEnv(env.pack, env.table, order.cpu().numpy(), task=env.task,
                               max_episode_steps=env.max_episode_steps,
                               with_visual=env.with_visual if with_visual is None else with_visual,
                               render_size=env.render_size, dynamics=env.dynamics, success_reward=env.success_reward,
                               slack_reward=env.slack_reward, control=env.control, action_specs=env.action_specs,
                               device=device)


def state_rows(st, idx):
    """The envs ``idx`` of a RearrangeState."""
    import dataclasses

    return type(st)(**{f.name: getattr(st, f.name)[idx.to(st.pos.device)] for f in dataclasses.fields(st)})


def head_frames(env, st):
    """The env's head render of ``st``, semantics included (its observations
    keep depth and RGB only)."""
    import torch

    from habitat_torch.ops import raycast as rc
    from habitat_torch.tasks.rearrange.rigid_body import add_y

    h, w = env.render_size
    return rc.render_batch(env.pack, env._sid(st), add_y(st.pos, 1.25), st.yaw, torch.full_like(st.yaw, -0.45),
                           height=h, width=w, dynamic=env._dynamic_geometry(st))


def pool_check(tag, args):
    """max_pool_3x3s2_bwd on card inputs (x, y, dy): fails unless the wrapper
    launched its kernel and the result equals the plain version's bit for
    bit. Returns (the result, max |kernel - plain|)."""
    import torch

    from habitat_torch.ops import pool

    before = pool.max_pool_3x3s2_bwd.launches
    gx = pool.max_pool_3x3s2_bwd(*args)
    torch.cuda.synchronize()
    if pool.max_pool_3x3s2_bwd.launches != before + 1:
        fail("max_pool_3x3s2_bwd: wrapper did not launch its kernel")
    ref = pool.max_pool_3x3s2_bwd.plain(*args)
    err = (gx.float() - ref.float()).abs().max().item()
    if not torch.equal(gx, ref):
        fail(f"max_pool_3x3s2_bwd on the {tag} input: {int((gx != ref).sum().item())} elements differ from "
             f"the plain version, max |d| {err}")
    return gx, err


def step_split(env, st, act, reps=5):
    """ms of one env step and of its render (the head camera's observations
    on the same state), each timed with CUDA events."""
    step = cuda_ms(lambda: env.step_fn(st, act), reps)
    render = cuda_ms(lambda: env._observations(st), reps)
    return step, render


def pick_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[pick]: vision Pick trained at full width on ``dev``, and #3 and #11
    held to their plain versions on the path's own inputs; returns the
    launch counts of its train path and those checks' readings."""
    import numpy as np
    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of
    from habitat_torch.ops import pool
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    env = make_rearrange_env(with_visual=True, device=dev, **PICK)
    h, w = PICK["render_size"]
    if rc.render_route(env.pack, h, w, "pinhole", dynamic=True) != "index":
        fail("[pick] the head camera should take the index route")
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(env.num_actions, backbone="resnet9", hidden_size=128, goal_keys=(),
                                         input_hw=(h, w), state_keys=state_keys_of(env.observation_shapes), device=dev)
    lrn = PPOLearner(env, policy, PPOConfig(**PICK_TRAIN), measure_keys=("success", "pick_success"))
    split = {"rollout": [], "update": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lrn.collect_rollout = timed("rollout", lrn.collect_rollout)
    lrn.update = timed("update", lrn.update)
    log(f"[pick] setup {time.perf_counter() - t_phase:.1f} s: {len(env.table.obj_init)} episodes, pack "
        f"{tuple(env.pack.tri_mat.shape)}, state keys {list(policy.net.state_keys)}")
    T, N = PICK_TRAIN["num_steps"], PICK["num_envs"]
    renders = 1 + (1 + PICK_TRAIN_STEPS) * T
    updates = (1 + PICK_TRAIN_STEPS) * PICK_TRAIN["ppo_epoch"] * PICK_TRAIN["num_mini_batch"]
    # the pool backward's inputs at the path's last launch (the last
    # minibatch of the last update), kept for the check after the path
    pool_backward, last_bwd = pool._MaxPool3x3s2.backward, {}

    def backward_seen(ctx, dy):
        gx = pool_backward(ctx, dy)
        if pool.max_pool_3x3s2_bwd.launches == updates:
            x, y = ctx.saved_tensors
            last_bwd["args"] = (x, y, dy.contiguous(memory_format=torch.channels_last))
        return gx

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for p in plain_watch:
        p.start()
    rs = lrn.init(seed=0)
    walls = []
    with mock.patch.object(pool._MaxPool3x3s2, "backward", staticmethod(backward_seen)):
        for i in range(1 + PICK_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs, metrics = lrn.train_step(rs)
            metrics = {k: v.item() for k, v in metrics.items()}
            if i:
                walls.append(time.perf_counter() - t0)
            if not all(np.isfinite(v) for v in metrics.values()):
                fail(f"[pick] non-finite metrics {metrics}")
    torch.cuda.synchronize()
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[pick]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    peak = torch.cuda.max_memory_allocated()
    launches = path_counts("pick train path", raycast_index_t=2 * renders, max_pool_3x3s2_bwd=updates)
    rates = sorted(N * T / w_ for w_ in walls)
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    roll, upd = split["rollout"][1:], split["update"][1:]
    log(f"[pick] {gpu}: vision Pick N={N} {h}x{w} depth+RGB, resnet9 + LSTM-128, PPO T={T}: train env-steps/s "
        f"median {rates[len(rates) // 2]:.1f} (min {rates[0]:.1f}, max {rates[-1]:.1f}) over {PICK_TRAIN_STEPS} train "
        f"steps; rollout ms {[round(x, 1) for x in roll]} (median {med(roll):.1f}, {med(roll) / T:.2f} ms per env "
        f"step with the policy), update ms {[round(x, 1) for x in upd]} (warm-up {split['rollout'][0]:.1f} + "
        f"{split['update'][0]:.1f}); peak memory {peak / 2**30:.2f} GiB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k.startswith("losses/") or k == "grad_norm")
        + f"; episodes done {metrics['done_count']:.0f}, picked {metrics['m_pick_success']:.0f}; launches {launches} "
        f"(#3 twice per render, #11 {updates // (1 + PICK_TRAIN_STEPS)} per train step), no plain version on a card "
        f"tensor")
    del lrn.collect_rollout, lrn.update

    # #11 on the path's own input: the stem output of the update's last
    # minibatch, channels-last bf16, against its plain version
    x, y, dy = last_bwd.pop("args")
    mb_shape = (N * T // PICK_TRAIN["num_mini_batch"], 32, h // 2, w // 2)
    if tuple(x.shape) != mb_shape or x.dtype != torch.bfloat16 or not all(
            a.is_contiguous(memory_format=torch.channels_last) for a in (x, y, dy)):
        fail(f"[pick] the pool backward got {tuple(x.shape)} {x.dtype} (strides {x.stride()}), want {mb_shape} "
             f"bfloat16 channels-last")
    _, pool_err = pool_check(f"[pick] minibatch {mb_shape}", (x, y, dy))
    del x, y, dy
    # #3 on the path's own inputs: both launches of the head render of the
    # rollout's last state (the static scene on the index route, the per-env
    # dynamic pass) against its plain version, at the [kernel] gates; and the
    # frames against those rendered with the plain version
    st, obs = rs.env_state, rs.obs
    index_calls = []

    def index_seen(*a, **k):
        index_calls.append((a, k))
        return rk.raycast_index_t(*a, **k)

    with mock.patch.object(rc, "raycast_index_t", index_seen):
        frames = head_frames(env, st)
    if len(index_calls) != 2:
        fail(f"[pick] the head render made {len(index_calls)} raycast_index_t calls, want 2")
    index_check = {}
    for what, (a, k) in zip(("static", "dynamic"), index_calls):
        got, ref = rk.raycast_index_t(*a, **k), rk.raycast_index_t.plain(*a, **k)
        hit_a, idx_a, dt = agreement(f"[pick] raycast_index_t on the head render's {what} pass", got, ref)
        index_check[what] = dict(matrix=list(a[0].shape), rays=a[2].numel() // 16, hit_agree=hit_a,
                                 idx_agree=idx_a, max_abs_err=dt)
    with mock.patch.object(rc, "raycast_index_t", rk.raycast_index_t.plain):
        frames_p = head_frames(env, st)
    hit_f = share((frames["depth"] < 1.0) == (frames_p["depth"] < 1.0))
    sem_f = share(frames["semantic"] == frames_p["semantic"])
    if not (hit_f >= PICK_FRAME_AGREE and sem_f >= PICK_FRAME_AGREE):
        fail(f"[pick] the head frames agree with the plain version's on {hit_f} (hit/miss) and {sem_f} "
             f"(semantics) of pixels")
    del frames, frames_p, index_calls
    log(f"[pick] the path's own kernel inputs: max_pool_3x3s2_bwd on the last minibatch {mb_shape} bf16 "
        f"channels-last bit-equal to its plain version; raycast_index_t on the head render of the rollout's last "
        f"state (N={N}, {h}x{w}) against its plain version: " + "; ".join(
            f"{what} {r['matrix']} x {r['rays']} rays hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} |dt| "
            f"{r['max_abs_err']:.3g}" for what, r in index_check.items())
        + f"; frames' hit/miss {hit_f:.6f} and semantics {sem_f:.6f} equal to the plain version's")

    # the env step and its render, timed on the rollout's last state
    act = greedy_pick(obs)
    step_ms, render_ms = step_split(env, st, act)
    _, n_sync, first = count_syncs(lambda: env.step_fn(st, act))
    bare = env_like(env, env.device, with_visual=False)
    bare.step_fn(st, act)
    no_host_sync("pick", "step_fn without the render", lambda: bare.step_fn(st, act))
    n_prof = 3
    _, dev_ms, n_launch, top = device_time_and_launches(lambda: [env.step_fn(st, act) for _ in range(n_prof)])
    log(f"[pick] {gpu}: env step N={N} {step_ms:.3f} ms = render {render_ms:.3f} ms + step rest "
        f"{step_ms - render_ms:.3f} ms; {n_launch / n_prof:.0f} launches per step, device {dev_ms / n_prof:.3f} ms "
        f"per step, idle share {1 - dev_ms / (n_prof * step_ms):.3f} ({n_prof} profiled steps); with the render a "
        f"step makes {n_sync} synchronising calls (at {first}); without it none (checked under "
        f"set_sync_debug_mode('error'))")
    for e in top[:4]:
        log(f"[pick]   {device_us(e) / 1e3 / n_prof:8.4f} ms/step {e.count // n_prof:5d}x  {e.key[:80]}")

    # the greedy controller from a fresh reset: some env picks its target
    st, obs = env.reset_fn()
    picked_envs, first_step, bad = 0, None, 0
    t0 = time.perf_counter()
    for t in range(PICK_GREEDY_STEPS):
        st, obs, reward, done, info = env.step_fn(st, greedy_pick(obs))
        # an env that picked its target this step (its episode then ends)
        picked = info["did_pick_object"] > 0
        bad += int((picked & ((info["pick_success"] != 1) | (reward < env.success_reward) | ~done)).sum().item())
        n_picked = int(picked.sum().item())
        if n_picked and first_step is None:
            first_step = t
        picked_envs += n_picked
    greedy_s = time.perf_counter() - t0
    log(f"[pick] greedy controller {PICK_GREEDY_STEPS} steps ({greedy_s:.1f} s): {picked_envs} picks, the first at step "
        f"{first_step}; every pick with pick_success 1, reward >= {env.success_reward} and done; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not picked_envs or bad:
        fail(f"[pick] greedy controller: {picked_envs} picks, {bad} without pick_success 1, a reward of at least the "
             f"success reward or the episode's end")
    return launches, dict(index=index_check, pool=dict(shape=list(mb_shape), max_abs_err=pool_err))


def contact_recorder(calls, key):
    """contact_step, keeping its inputs and outputs in calls[key]."""
    from habitat_torch.tasks.rearrange import rearrange_env as renv

    real_step = renv.contact_step

    def run(*a, **k):
        out = real_step(*a, **k)
        calls[key] = (a, k, out)
        return out
    return run


def moved_boxes(call):
    """(N, O) bool: the free boxes whose position a recorded contact_step
    call changed."""
    a, _, out = call
    return (out[0] != a[0]).any(-1) & a[2]


def step_against_cpu(tag, env_c, env_g, s, acts, dev):
    """One env step from the CPU state ``s`` on the CPU and on the card.
    Fails unless held, done, success and the grasp-constraint flag are
    equal; the state sensors and reward are within 1e-5 in envs where the
    contact step moved no box, and within 1e-5 + MOVED_SENSOR_FACTOR times
    the card's |dp| where it did; the contact step's outputs meet the
    [contacts] float64 gates; and the head frames' hit/miss and semantics
    agree on PICK_FRAME_AGREE of pixels. Returns the readings and the CPU's
    next state."""
    import torch

    from habitat_torch.tasks.rearrange import rearrange_env as renv

    calls = {}
    with mock.patch.object(renv, "contact_step", contact_recorder(calls, "cpu")):
        sc, oc, rc_, dc, ic = env_c.step_fn(s, acts)
    with mock.patch.object(renv, "contact_step", contact_recorder(calls, "card")):
        sg, og, rg, dg, ig = env_g.step_fn(s.to(dev), acts.to(dev))
    for k, g, c in (("held", sg.held, sc.held), ("done", dg, dc), ("success", ig["success"], ic["success"]),
                    ("constraint_violation", ig["constraint_violation"], ic["constraint_violation"])):
        if not torch.equal(g.cpu(), c):
            fail(f"[pick-contacts] {tag}: {k} differs between the card and the CPU")
    a, k, out_c = calls["cpu"]
    to64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x  # noqa: E731
    ref64 = renv.contact_step(*(to64(x) for x in a), **{kk: to64(v) for kk, v in k.items()})
    gap = {}
    for name, g, c32, c64 in zip(("p", "v", "force", "q", "w"), calls["card"][2], out_c, ref64):
        atol, rtol = (FORCE_ATOL, FORCE_RTOL) if name == "force" else (PHYS_ATOL, PHYS_W_RTOL if name == "w" else 0.0)
        gap[name] = held_to_float64("pick-contacts", f"{tag} {name}", g, c32, c64, atol, rtol)["gap"]
    moved = moved_boxes(calls["cpu"])
    near = moved.any(-1)
    d = (rg.cpu() - rc_).abs()
    for key in oc:
        if not key.startswith("robot_head"):
            d = torch.maximum(d, (og[key].cpu() - oc[key]).abs().reshape(len(d), -1).amax(-1))
    tol = torch.where(near, 1e-5 + MOVED_SENSOR_FACTOR * gap["p"], 1e-5)
    if not (d <= tol).all():
        fail(f"[pick-contacts] {tag}: state sensors or reward {d.tolist()} from the CPU's, allowed {tol.tolist()}")
    fc, fg = head_frames(env_c, sc), head_frames(env_g, sg)
    hit = share((fc["depth"] < 1.0) == (fg["depth"].cpu() < 1.0))
    sem = share(fc["semantic"] == fg["semantic"].cpu())
    if not (hit >= PICK_FRAME_AGREE and sem >= PICK_FRAME_AGREE):
        fail(f"[pick-contacts] {tag}: frames agree on {hit} (hit/miss) and {sem} (semantics) of pixels")
    return dict(moved=int(moved.sum()), gap=gap, still=d[~near].max().item() if (~near).any() else 0.0,
                near=d[near].max().item() if near.any() else 0.0, frames=min(hit, sem), next=sc,
                success=ic["success"])


def pick_contacts_phase(gpu, dev, zero_counts, path_counts):
    """[pick-contacts]: pick_procgen.yaml's values at N=128 on ``dev``: the
    settled reset, the greedy controller, ms per env step and its split, and
    steps on the card against the CPU from the same states (the reset, a held
    box, its drop, the robot against a box, the greedy step that moved the
    most boxes); returns the launch counts of the greedy episode."""
    import dataclasses

    import torch

    from habitat_torch.tasks.rearrange import rearrange_env as renv
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    env = make_rearrange_env(with_visual=True, device=dev, **PICK_CONTACTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    N, steps = PICK_CONTACTS["num_envs"], PICK_CONTACTS_STEPS
    zero_counts()
    st, obs = env.reset_fn()
    walls = []
    real_step = renv.contact_step
    picks = 0
    states = []  # every step's (state, action) of the greedy episode
    for t in range(steps):
        act = greedy_pick(obs)
        states.append((st, act))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, obs, reward, done, info = env.step_fn(st, act)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        picks += int((info["pick_success"] > 0).sum().item())
    launches = path_counts("pick-contacts episode", raycast_index_t=2 * (1 + steps))
    # the split: every eighth step again, the contact step and the render
    # each timed inside it (synchronised before and after), the rest as
    # what the step's wall leaves
    part = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            part[name] = time.perf_counter() - t0
            return out
        return run

    split = []
    with mock.patch.object(renv, "contact_step", timed("physics", real_step)), \
            mock.patch.object(renv, "render_batch", timed("render", renv.render_batch)):
        for s_, a_ in states[::8]:
            timed("step", env.step_fn)(s_, a_)
            split.append((part["physics"], part["render"], part["step"] - part["physics"] - part["render"]))
    ms = sorted(w_ * 1e3 for w_ in walls[1:])
    med = ms[len(ms) // 2]
    phys_ms, rend_ms, rest_ms = (sorted(x)[len(x) // 2] * 1e3 for x in zip(*split))
    n_prof = 3
    s_p, a_p = states[-1]

    def prof_steps():
        s = s_p
        for _ in range(n_prof):
            s = env.step_fn(s, a_p)[0]
        return s

    _, dev_ms, n_launch, top = device_time_and_launches(prof_steps)
    idle = 1 - dev_ms / (med * n_prof)
    bare = env_like(env, env.device, with_visual=False)
    bare.step_fn(s_p, a_p)
    no_host_sync("pick-contacts", "step_fn without the render", lambda: bare.step_fn(s_p, a_p))
    _, n_sync, first = count_syncs(lambda: env.step_fn(s_p, a_p))
    hh, ww = PICK_CONTACTS["render_size"]
    log(f"[pick-contacts] {gpu}: pick_procgen.yaml values at N={N} (contacts v6, {hh}x{ww} head depth+RGB, "
        f"{len(env.table.obj_init)} episodes, setup with settling {setup_s:.1f} s): ms per env step median {med:.3f} "
        f"(min {ms[0]:.3f}, max {ms[-1]:.3f}) over {steps - 1} greedy steps after the first; split (medians over "
        f"{len(split)} of its steps replayed, each part synchronised) physics {phys_ms:.3f} + render {rend_ms:.3f} + "
        f"rest {rest_ms:.3f} ms; {n_launch / n_prof:.0f} "
        f"launches per step, device {dev_ms / n_prof:.3f} ms per step, idle share {idle:.3f} ({n_prof} profiled "
        f"steps against the median); {picks} picks; #3 launches {launches['raycast_index_t']} (twice per render); "
        f"{n_sync} synchronising calls per step with the render (at {first}), none without it")
    for e in top[:6]:
        log(f"[pick-contacts]   {device_us(e) / 1e3 / n_prof:8.4f} ms/step {e.count // n_prof:5d}x  {e.key[:80]}")

    # the card against the CPU at N=PICK_CHECK_ENVS, from the same states,
    # on the episode's own table and pack
    n = PICK_CHECK_ENVS
    first = torch.arange(n)
    env_c, env_g = env_like(env, "cpu", first), env_like(env, dev, first)
    s0, _ = env_c.reset_fn()
    moves = torch.tensor([renv.A_FWD, renv.A_LEFT, renv.A_RIGHT, renv.A_FWD] * (n // 4), dtype=torch.int32)
    turns = torch.tensor([renv.A_LEFT, renv.A_RIGHT] * (n // 2), dtype=torch.int32)
    held_state = dataclasses.replace(s0, held=env_c.table.pick_target[s0.ep_idx])
    checks = {"step 0": step_against_cpu("step 0", env_c, env_g, s0, moves, dev),
              "held box": step_against_cpu("held box", env_c, env_g, held_state, moves, dev)}
    # the drop: the held box released from the EE, then its fall, each step
    # from the CPU's state (teacher-forced)
    s_, a_ = held_state, torch.full((n,), renv.A_GRAB, dtype=torch.int32)
    for i in range(PICK_DROP_STEPS):
        checks[f"drop {i}"] = step_against_cpu(f"drop {i}", env_c, env_g, s_, a_, dev)
        s_, a_ = checks[f"drop {i}"]["next"], turns
    # the robot against a box: each env's first box put inside the robot's
    # radius (its centre AGENT_RADIUS + half its smaller half-extent away),
    # the robot turning in place
    half = env_c.table.obj_half[s0.ep_idx]
    o = env_c.table.obj_valid[s0.ep_idx].to(torch.uint8).argmax(1)
    lane = torch.arange(n)
    reach = renv.AGENT_RADIUS + 0.5 * torch.minimum(half[lane, o, 0], half[lane, o, 2])
    box = s0.obj_pos[lane, o]
    against = dataclasses.replace(s0, pos=torch.stack([box[:, 0] - reach, s0.pos[:, 1], box[:, 2]], -1))
    checks["robot against a box"] = step_against_cpu("robot against a box", env_c, env_g, against, turns, dev)
    for tag in ("drop 0", "robot against a box"):
        if not checks[tag]["moved"]:
            fail(f"[pick-contacts] {tag}: the contact step moved no box")
    # the greedy episode's step whose contact step moved boxes in the most
    # envs (the robot reaching them), on those envs
    moved_envs = []
    for t, (s_, a_) in enumerate(states):
        calls = {}
        with mock.patch.object(renv, "contact_step", contact_recorder(calls, "card")):
            bare.step_fn(s_, a_)
        moved_envs.append(moved_boxes(calls["card"]).any(-1).nonzero().flatten().cpu())
    t_best = max(range(steps), key=lambda t: len(moved_envs[t]))
    greedy_moved = sum(len(m) for m in moved_envs)
    if not len(moved_envs[t_best]):
        fail("[pick-contacts] the greedy episode's contact steps moved no box: no greedy state to compare")
    idx = moved_envs[t_best][:n]
    s_, a_ = states[t_best]
    checks[f"greedy step {t_best}"] = step_against_cpu(
        f"greedy step {t_best}", env_like(env, "cpu", idx), env_like(env, dev, idx), state_rows(s_, idx).to("cpu"),
        a_[idx.to(dev)].cpu(), dev)
    log(f"[pick-contacts] card vs CPU at N<={n} from the same states on the episode's table: held, done, success and "
        f"the grasp-constraint flag equal; state sensors and reward within 1e-5 where no box moved, within 1e-5 + "
        f"{MOVED_SENSOR_FACTOR} |dp| where one did; the contact step within its float64 gates; frames' hit/miss and "
        f"semantics equal on >= {PICK_FRAME_AGREE} of pixels. " + "; ".join(
            f"{tag}: {c['moved']} boxes moved, |dp| {c['gap']['p']:.2e} |dv| {c['gap']['v']:.2e} |dq| "
            f"{c['gap']['q']:.2e} |dw| {c['gap']['w']:.2e} force {c['gap']['force']:.2e}, sensors/reward "
            f"{c['still']:.2e} still / {c['near']:.2e} moved, frames {c['frames']:.5f}" for tag, c in checks.items())
        + f". The greedy episode's contact steps moved boxes in {greedy_moved} env-steps of {steps} x {N}; the "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def same_tensors(tag, a, b):
    """Fails unless the dicts or dataclasses of tensors ``a`` and ``b`` hold
    the same keys and equal tensors, bit for bit."""
    import dataclasses

    import torch

    if dataclasses.is_dataclass(a):
        a, b = ({f.name: getattr(x, f.name) for f in dataclasses.fields(x)} for x in (a, b))
    if set(a) != set(b):
        fail(f"[config] {tag}: keys {sorted(a)} against {sorted(b)}")
    for k in a:
        if dataclasses.is_dataclass(a[k]) or isinstance(a[k], dict):
            same_tensors(f"{tag}.{k}", a[k], b[k])
        elif not torch.equal(a[k], b[k]):
            fail(f"[config] {tag}: {k} differs")


def config_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[config]: the run entry point trains and evaluates
    ppo_pointnav_example.yaml on the card; pick_procgen.yaml's env from the
    config equals the one built by hand; a declared-actions env steps
    without a host sync and agrees with the CPU, its suction grip holding,
    grabbing and releasing. Returns the launch counts of the train and eval
    runs."""
    import dataclasses
    import tempfile

    import torch

    from habitat_torch.baselines import run
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    trainers = []
    build, build_env = construct.trainer_from_config, construct.env_from_config

    def kept(*a, **k):
        trainers.append(build(*a, **k))
        return trainers[-1]

    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(construct, "trainer_from_config", kept):
        args = [f"--config-name={CONFIG_EXPERIMENT}", f"habitat_baselines.checkpoint_folder={tmp}/ckpt",
                f"habitat_baselines.tensorboard_dir={tmp}/tb", "habitat_baselines.log_interval=1"]
        cfg = get_config(CONFIG_EXPERIMENT + ".yaml")
        hb = cfg.habitat_baselines
        n, T = hb.num_environments, hb.rl.ppo.num_steps
        steps = CONFIG_UPDATES * n * T
        # (a) train: the reset's render and one per rollout step through #1,
        # one max-pool backward per minibatch of each epoch
        zero_counts()
        for p in plain_watch:
            p.start()
        t0 = time.perf_counter()
        metrics = run.main(args + [f"habitat_baselines.total_num_steps={steps}"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        for p in plain_watch:
            p.stop()
        train = path_counts("[config] run.main train", raycast_fused_sel_t=1 + CONFIG_UPDATES * T,
                            max_pool_3x3s2_bwd=CONFIG_UPDATES * hb.rl.ppo.ppo_epoch * hb.rl.ppo.num_mini_batch)
        trainer = trainers[-1]
        enc = trainer.policy.net.encoder
        if (trainer.env.device.type != dev.type or trainer.num_updates_done != CONFIG_UPDATES
                or enc.visual_inputs != ("depth",) or trainer.policy.net.hidden_size != 512
                or not all(v == v for v in metrics.values())):
            fail(f"[config] the trained run: device {trainer.env.device}, {trainer.num_updates_done} updates, "
                 f"inputs {enc.visual_inputs}, metrics {metrics}")
        tb = os.listdir(os.path.join(tmp, "tb")) if os.path.isdir(os.path.join(tmp, "tb")) else []
        if not any(f.startswith("events.out.tfevents") for f in tb):
            fail(f"[config] tensorboard_dir holds no TensorBoard events file: {tb}")
        final = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
        # (b) eval from that latest: one render per env step and the reset's
        zero_counts()
        for p in plain_watch:
            p.start()
        env_steps = []

        def counted(env):
            step = env.step_fn

            def run_step(*a):
                env_steps.append(1)
                return step(*a)
            env.step_fn = run_step
            return env

        with mock.patch.object(construct, "env_from_config", lambda *a, **k: counted(build_env(*a, **k))):
            t0 = time.perf_counter()
            ev = run.main(args + ["--run-type", "eval"])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
        for p in plain_watch:
            p.stop()
        evl = path_counts("[config] run.main eval", raycast_fused_sel_t=1 + len(env_steps))
        loaded = trainers[-1].policy.state_dict()
        if not all(torch.equal(final[k], loaded[k]) for k in final):
            fail("[config] the evaluated parameters differ from the trained ones")
        per_env = max(1, hb.test_episode_count // n)
        if ev.get("num_episodes") != per_env * n:
            fail(f"[config] eval counted {ev.get('num_episodes')} episodes, want {per_env} x {n}")
    if plain_on_card:
        fail(f"[config]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    log(f"[config] {gpu}: python -m habitat_torch.baselines.run --config-name={CONFIG_EXPERIMENT} at its own width "
        f"({n} envs, {hb.rl.ddppo.backbone} {list(enc.visual_inputs)} "
        f"{trainer.env.observation_shapes['depth'][0]}, LSTM-{trainer.policy.net.hidden_size}, T={T}): "
        f"{CONFIG_UPDATES} updates in {train_s:.1f} s with the set-up (losses/learner_loss "
        f"{metrics['losses/learner_loss']:.4f}), launches #1 {train['raycast_fused_sel_t']} (1 + {CONFIG_UPDATES} x "
        f"{T}) and #11 {train['max_pool_3x3s2_bwd']}; tensorboard files {len(tb)}; --run-type eval from latest "
        f"(parameters bit-equal) in {eval_s:.1f} s: {ev['num_episodes']:.0f} episodes, success {ev['success']:.4f}, "
        f"SPL {ev['spl']:.4f}, {len(env_steps)} env steps, #1 launches {evl['raycast_fused_sel_t']}; no plain "
        f"version on a card tensor")

    # (c) pick_procgen.yaml from the config against the [pick-contacts] env
    t0 = time.perf_counter()
    pick_cfg = get_config("benchmark/rearrange/pick_procgen.yaml")
    zero_counts()
    by_cfg = construct.env_from_config(pick_cfg, num_envs=PICK_CONTACTS["num_envs"])
    by_hand = make_rearrange_env(with_visual=True, device=dev, **{**PICK_CONTACTS, "seed": pick_cfg.habitat.seed})
    same_tensors("pick tables", by_cfg.table, by_hand.table)
    same_tensors("pick orders", {"order": by_cfg.order}, {"order": by_hand.order})
    # the yaml declares no lab sensor and no measure: the config's env emits
    # the head frames and its bookkeeping measures, each equal to the hand
    # env's; both take the greedy controller's actions on the hand env's
    # state sensors
    (sc, oc), (sh, oh) = by_cfg.reset_fn(), by_hand.reset_fn()
    for t in range(CONFIG_GREEDY_STEPS + 1):
        same_tensors(f"pick state {t}", sc, sh)
        same_tensors(f"pick obs {t}", oc, {k: oh[k] for k in oc})
        if t == CONFIG_GREEDY_STEPS:
            break
        act = greedy_pick(oh)
        sc, oc, rc_, dc, ic = by_cfg.step_fn(sc, act)
        sh, oh, rh, dh, ih = by_hand.step_fn(sh, act)
        same_tensors(f"pick step {t}", dict(reward=rc_, done=dc, **ic), dict(reward=rh, done=dh, **{k: ih[k] for k in ic}))
    renders = 2 * (1 + CONFIG_GREEDY_STEPS)
    pick = path_counts("[config] pick_procgen env", raycast_index_t=2 * renders)
    log(f"[config] env_from_config(pick_procgen.yaml, num_envs={by_cfg.num_envs}) equals the [pick-contacts] env "
        f"built by hand bit for bit (tables, order, the reset and {CONFIG_GREEDY_STEPS} greedy steps: state, "
        f"observations {sorted(oc)}, reward, done, info {sorted(ic)}), {time.perf_counter() - t0:.1f} s; #3 launches "
        f"{pick['raycast_index_t']} (twice per render, {renders} renders)")

    # (d) declared actions: arm (joint deltas + suction grip), base, stop;
    # state sensors and measures declared
    t0 = time.perf_counter()
    spec_cfg = get_config("benchmark/rearrange/pick_procgen.yaml", list(CONFIG_SPEC_DECLARED))
    env = construct.rearrange_env_from_config(spec_cfg, num_envs=PICK_CONTACTS["num_envs"], with_visual=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (CONFIG_SPEC_STEPS, env.num_envs, env.action_dim)
    acts = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    stop = torch.rand(shape[:2], generator=gen, device=dev) < CONFIG_SPEC_STOP
    acts[..., -1] = torch.where(stop, 1.0, -1.0)
    st, _ = env.reset_fn()
    states = []
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(CONFIG_SPEC_STEPS):
            states.append(st)
            st, _, reward, done, _ = env.step_fn(st, acts[t])
    except RuntimeError as e:
        fail(f"[config] a declared-actions step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    path_counts("[config] declared-actions steps")
    idx = torch.arange(PICK_CHECK_ENVS)
    env_c, env_g = env_like(env, "cpu", idx), env_like(env, dev, idx)
    checks = {f"step {t}": step_against_cpu(f"[config] declared-actions step {t}", env_c, env_g,
                                            state_rows(states[t], idx).to("cpu"), acts[t][idx.to(dev)].cpu(), dev)
              for t in CONFIG_SPEC_CHECKS}
    # the suction grip from placed states (random actions seldom bring the
    # EE within grasp distance): each env's target box held and kept (grip
    # slot > 0), the same box released (grip slot <= 0) and its fall
    # teacher-forced, and the target box put at the EE and grabbed; the arm,
    # base and stop slots idle
    s0 = state_rows(states[0], idx).to("cpu")
    target = env_c.table.pick_target[s0.ep_idx]
    held = dataclasses.replace(s0, held=target)
    at_ee = dataclasses.replace(s0, obj_pos=s0.obj_pos.index_put((torch.arange(len(idx)), target.long()),
                                                                 env_c._ee_pos(s0)))
    grip_at = sum(env._spec_dims[:list(env.action_names).index("arm_action") + 1]) - 1

    def grip(g):
        a = torch.zeros(len(idx), env.action_dim)
        a[:, grip_at] = g
        a[:, -1] = -1.0  # rearrange_stop: no stop
        return a

    for tag, s_, g in (("held box kept", held, 1.0), ("box at the EE grabbed", at_ee, 1.0)):
        checks[tag] = step_against_cpu(f"[config] {tag}", env_c, env_g, s_, grip(g), dev)
        if not (checks[tag]["success"] > 0).all():  # pick success: the target held after the step
            fail(f"[config] {tag}: the target is held in {checks[tag]['success'].tolist()} of the envs")
    s_ = held
    for i in range(PICK_DROP_STEPS):
        checks[f"release {i}"] = step_against_cpu(f"[config] release {i}", env_c, env_g, s_, grip(-1.0), dev)
        s_ = checks[f"release {i}"]["next"]
    if not (checks["release 0"]["next"].held < 0).all():
        fail(f"[config] release 0: the suction grip released nothing, held {checks['release 0']['next'].held.tolist()}")
    if not checks["release 0"]["moved"]:
        fail("[config] release 0: the contact step moved no box")
    dones = int(st.episode_count.sum().item())
    log(f"[config] declared actions {list(env.action_names)} ({env.action_dim} floats, control {env.control}, "
        f"{env.dynamics}), sensors {list(env.observation_shapes)}, measures {list(env.measure_keys)} at "
        f"N={env.num_envs}: {CONFIG_SPEC_STEPS} steps under set_sync_debug_mode('error'), "
        f"{dones} episodes ended by rearrange_stop, no launch; card vs CPU at N={PICK_CHECK_ENVS} from steps "
        f"{list(CONFIG_SPEC_CHECKS)} and the grip's held, grab and release states: " + "; ".join(
            f"{tag}: {c['moved']} boxes moved, |dp| {c['gap']['p']:.2e}, sensors/reward {c['still']:.2e} still / "
            f"{c['near']:.2e} moved" for tag, c in checks.items()) + f"; {time.perf_counter() - t0:.1f} s")
    wall = time.perf_counter() - t_phase
    log(f"[config] the phase {wall:.1f} s")
    if wall > CONFIG_SECONDS:
        fail(f"[config] took {wall:.1f} s, more than {CONFIG_SECONDS} s")
    return dict(train=train, eval=evl)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def wall_ms(dev, fn, reps):
    """ms per call of fn() over ``reps`` synced calls after one warm-up."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def state_to(st, dev):
    """A nav ``EnvState`` (measure states included) copied to ``dev``."""
    import dataclasses

    import torch

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        return {m: {k: x.to(dev) for k, x in d.items()} for m, d in v.items()}

    return dataclasses.replace(st, **{f.name: move(getattr(st, f.name)) for f in dataclasses.fields(st)})


def recipe_run(tag, lrn, updates, dev):
    """lrn.init(seed=0) and ``updates`` train steps, each timed with its
    rollout / update split; fails on a non-finite metric. Returns (rollout
    state, wall seconds per update, rollout ms, update ms, last metrics)."""
    import numpy as np

    split = {"rollout": [], "update": []}

    def timed(name, fn):
        def run(*args):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            sync(dev)
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lrn.collect_rollout, lrn.update = timed("rollout", lrn.collect_rollout), timed("update", lrn.update)
    rs, walls = lrn.init(seed=0), []
    for _ in range(updates):
        sync(dev)
        t0 = time.perf_counter()
        rs, metrics = lrn.train_step(rs)
        metrics = {k: v.item() for k, v in metrics.items()}
        walls.append(time.perf_counter() - t0)
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"{tag} non-finite metrics {metrics}")
    del lrn.collect_rollout, lrn.update
    return rs, walls, split["rollout"], split["update"], metrics


def recipe_text(n, T, walls, roll, upd, metrics):
    rates = [n * T / w for w in walls]
    return (f"{len(walls)} updates of {n} x {T} env steps: seconds per update {[round(w, 3) for w in walls]} "
            f"(the first with cuDNN's and the allocator's warm-up), env-steps/s {[round(r, 1) for r in rates]}; "
            f"rollout ms {[round(x, 1) for x in roll]}, update ms {[round(x, 1) for x in upd]}; last losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k.startswith("losses/")))


def idle_text(dev, env, st, act, n_prof=3):
    """``n_prof`` env steps from ``st`` under torch.profiler (after the gated
    path; a whole train step, ~100,000 launches, takes about a minute
    there): ms, device ms, idle share and launches per env step."""
    if dev.type != "cuda":
        return "not profiled off the card"
    step_ms = wall_ms(dev, lambda: env.step_fn(st, act), 5)
    _, dev_ms, n_launch, _ = device_time_and_launches(lambda: [env.step_fn(st, act) for _ in range(n_prof)])
    return (f"env step {step_ms:.3f} ms, device {dev_ms / n_prof:.3f} ms (idle share "
            f"{1 - dev_ms / (n_prof * step_ms):.3f}), {n_launch / n_prof:.0f} launches per env step")


def objectnav_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, env_size=ONAV_ENV,
                    recipe=ONAV_RECIPE, updates=RECIPE_UPDATES, ppo=RECIPE_PPO):
    """[objectnav]: (a) objectnav_procgen.yaml's env at its own widths on
    ``dev``, a look_up/look_down schedule with its state sensors held to the
    CPU and #1 held to its plain version at nonzero pitch; (b) the ObjectNav
    train recipe for ``updates`` updates. Returns the launch counts."""
    import numpy as np
    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.core.batched_env import BatchedEnv
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.object_nav import make_procedural_objectnav
    from habitat_torch.models.policy import make_pointnav_resnet_policy, obs_inputs_of
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = get_config("benchmark/nav/objectnav/objectnav_procgen.yaml")
    n, steps = env_size["num_envs"], env_size["steps"]
    zero_counts()
    for p in plain_watch:
        p.start()
    env = construct.env_from_config(cfg, num_envs=n, device=dev)
    shapes = env.observation_shapes
    want = {"rgb": ((128, 128, 3), torch.uint8), "depth": ((128, 128, 1), torch.float32),
            "semantic": ((128, 128, 1), torch.int32), "objectgoal": ((1,), torch.int32),
            "compass": ((1,), torch.float32), "gps": ((2,), torch.float32)}
    if shapes != want or env.num_actions != 6 or env.table.num_episodes != 64 or env.pack.num_scenes != 4:
        fail(f"[objectnav] the yaml's env: {shapes}, {env.num_actions} actions, {env.table.num_episodes} episodes")
    # the same env's state sensors on the CPU: each step starts from the card
    # state moved over
    cpu_env = BatchedEnv(env.pack, env.table, env.order.cpu().numpy(), env.state_sensors, env.measures, env.actions,
                         device=cpu, max_episode_steps=env.max_episode_steps, reward_spec=env.reward_spec,
                         slide_substeps=env.slide_substeps)
    keys = ("objectgoal", "gps", "compass")
    st, obs = env.reset_fn()
    _, obs_c = cpu_env.reset_fn()
    worst, tilted = 0.0, 0
    for t in range(steps + 1):
        for k in keys:
            err = (obs[k].cpu().double() - obs_c[k].double()).abs().max().item()
            worst = max(worst, err)
            if err > NAV_OBS_ATOL or obs[k].dtype != obs_c[k].dtype:
                fail(f"[objectnav] {k} at step {t}: card - CPU {err}")
        if t == steps:
            break
        acts = torch.tensor([ONAV_SCHEDULE[(t + i) % len(ONAV_SCHEDULE)] for i in range(n)], dtype=torch.int32)
        st_c, obs_c, _, done_c, _ = cpu_env.step_fn(state_to(st, cpu), acts)
        st, obs, _, done, _ = env.step_fn(st, acts.to(dev))
        if not torch.equal(done.cpu(), done_c):
            fail(f"[objectnav] done at step {t}: card {done.tolist()}, CPU {done_c.tolist()}")
        tilted += int((st.pitch.abs() > 0.1).sum().item())
    sync(dev)
    groups = len(env._render_groups)
    env_launches = path_counts("[objectnav] yaml env", raycast_fused_sel_t=groups * (1 + steps))
    # #1 at nonzero pitch: the last state's render on check_envs envs
    m = env_size["check_envs"]
    ctx = env._make_ctx(st)
    g = env._render_groups[0]
    pitch = st.pitch[:m]
    if not (pitch.abs() > 0.1).all():
        fail(f"[objectnav] the checked envs' pitch {pitch.tolist()} should all be nonzero")
    kernel, args, kwargs, _ = rc.closest_hit_call(env.pack, ctx.sid[:m], st.pos[:m] + g["cam_offset"], st.yaw[:m],
                                                 pitch, height=g["h"], width=g["w"])
    if kernel is not rk.raycast_fused_sel_t:
        fail("[objectnav] the yaml's frames should take the frustum-selected kernel")
    hit_a, idx_a, dt = agreement("[objectnav] raycast_fused_sel_t at nonzero pitch", kernel(*args, **kwargs),
                                 kernel.plain(*args, **kwargs))
    for p in plain_watch:
        p.stop()
    log(f"[objectnav] {gpu}: objectnav_procgen.yaml at its widths (N={n}, 128x128 RGB + depth + semantic, 6 actions, "
        f"{env.pack.num_scenes} scenes x {env.table.num_episodes // env.pack.num_scenes} episodes): reset + {steps} "
        f"steps with look_up/look_down ({tilted} env-steps at |pitch| > 0.1); objectgoal, gps, compass card - CPU "
        f"max {worst:.3g} (gate {NAV_OBS_ATOL}); #1 launches {env_launches['raycast_fused_sel_t']} = {groups} render "
        f"group x (1 reset + {steps} steps); raycast_fused_sel_t on {m} envs at pitch "
        f"{[round(x, 3) for x in pitch.tolist()]} against its plain version: hit {hit_a:.6f} idx {idx_a:.6f} |dt| "
        f"{dt:.3g}")
    yaml_step = idle_text(dev, env, st, acts.to(dev))

    # (b) the train recipe
    t0 = time.perf_counter()
    scenes, episodes, fields = make_procedural_objectnav(
        num_scenes=recipe["num_scenes"], episodes_per_scene=recipe["episodes_per_scene"], seed=recipe["seed"],
        extent=recipe["extent"])
    gen_s = time.perf_counter() - t0
    hw, N, T = recipe["hw"], recipe["num_envs"], ppo["num_steps"]
    zero_counts()
    for p in plain_watch:
        p.start()
    env = make_nav_env(scenes, episodes, num_envs=N, precomputed_fields=fields,
                       max_episode_steps=recipe["max_episode_steps"], device=dev,
                       sensor_specs=(("HabitatSimDepthSensor", {"height": hw, "width": hw}), ("ObjectGoalSensor", None),
                                     ("CompassSensor", None), ("GPSSensor", None)))
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(env.num_actions, visual_inputs=("depth",), input_hw=(hw, hw),
                                         backbone="resnet9", hidden_size=recipe["hidden_size"], goal_keys=(),
                                         **obs_inputs_of(env.observation_shapes), device=dev)
    lrn = PPOLearner(env, policy, PPOConfig(**ppo))
    rs, walls, roll, upd, metrics = recipe_run("[objectnav] recipe", lrn, updates, dev)
    sync(dev)
    for p in plain_watch:
        p.stop()
    # one render per env step and the reset's; one pool backward per
    # minibatch of each epoch (one encoder)
    mb = ppo["ppo_epoch"] * ppo["num_mini_batch"]
    train = path_counts("[objectnav] recipe", raycast_fused_sel_t=1 + updates * T, max_pool_3x3s2_bwd=updates * mb)
    if plain_on_card:
        fail(f"[objectnav]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    if not policy.net.objectgoal_embed or policy.net.state_keys != ("gps", "compass"):
        fail(f"[objectnav] the recipe's net embeds {policy.net.state_keys}, objectgoal {policy.net.objectgoal_embed}")
    act = torch.ones(N, dtype=torch.int32, device=dev)
    log(f"[objectnav] {gpu}: scripts/train_objectnav_tpu.py's recipe ({recipe['num_scenes']} scenes x "
        f"{recipe['episodes_per_scene']} episodes generated in {gen_s:.1f} s, N={N}, {hw}x{hw} depth + objectgoal "
        f"embedding + compass + gps, resnet9 + LSTM-{recipe['hidden_size']}, 4 actions, PPO T={T}): "
        + recipe_text(N, T, walls, roll, upd, metrics)
        + f"; launches #1 {train['raycast_fused_sel_t']} = 1 + {updates} x {T}, #11 {train['max_pool_3x3s2_bwd']} = "
        f"{updates} x {ppo['ppo_epoch']} epochs x {ppo['num_mini_batch']} minibatches; no plain version on a card "
        f"tensor; " + idle_text(dev, env, rs.env_state, act)
        + f"; the yaml env (N={n}, 128x128 RGB + depth + semantic): {yaml_step}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(env=env_launches, train=train)


def imagenav_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, env_size=INAV_ENV,
                   recipe=INAV_RECIPE, updates=RECIPE_UPDATES, ppo=RECIPE_PPO):
    """[imagenav]: (a) imagenav_procgen.yaml's env on ``dev``: the goal
    images rendered at table build through #1, held to the plain render on
    the CPU; constant within an episode and not the start view; (b) the
    ImageNav train recipe (two encoders). Returns the launch counts."""
    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.core import dataset as tds
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.policy import make_pointnav_resnet_policy, obs_inputs_of
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    t_phase = time.perf_counter()
    cfg = get_config("benchmark/nav/imagenav/imagenav_procgen.yaml")
    n = env_size["num_envs"]
    zero_counts()
    for p in plain_watch:
        p.start()
    t0 = time.perf_counter()
    env = construct.env_from_config(cfg, num_envs=n, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    table_launches = path_counts("[imagenav] table build", raycast_fused_sel_t=1)
    E, size = env.table.num_episodes, cfg.habitat.task.lab_sensors.imagegoal.width
    if E != 128 or tuple(env.table.goal_image.shape) != (E, size, size, 3) or env.table.goal_image.device.type != dev.type:
        fail(f"[imagenav] goal table {tuple(env.table.goal_image.shape)} on {env.table.goal_image.device}")
    # the goal renders' closest hit against #1's plain version on the same
    # inputs, and the goal images against the plain render on the CPU
    scenes, episodes, _ = construct.load_dataset(cfg.habitat.dataset)
    views = [tds.goal_view(e) for e in episodes]
    index = {s.scene_id: i for i, s in enumerate(scenes)}
    sids = torch.tensor([index[e.scene_id] for e in episodes], dtype=torch.int32, device=dev)
    cam = torch.tensor([v[0].tolist() for v in views], device=dev)
    yaws = torch.tensor([v[1] for v in views], device=dev)
    kernel, args, kwargs, _ = rc.closest_hit_call(env.pack, sids, cam, yaws, torch.zeros_like(yaws), height=size,
                                                 width=size)
    for p in plain_watch:
        p.stop()
    if kernel is not rk.raycast_fused_sel_t:
        fail("[imagenav] the goal renders should take the frustum-selected kernel")
    hit_a, idx_a, dt = agreement("[imagenav] raycast_fused_sel_t on the goal renders", kernel(*args, **kwargs),
                                 kernel.plain(*args, **kwargs))
    t0 = time.perf_counter()
    cpu_goals = tds._render_goal_images(episodes, {s.scene_id: s for s in scenes}, index, size, device="cpu")
    cpu_s = time.perf_counter() - t0
    rgb_eq = share((env.table.goal_image.cpu() == cpu_goals).all(-1))
    if rgb_eq < GOAL_RGB_AGREE:
        fail(f"[imagenav] goal images equal to the CPU's on {rgb_eq} of pixels (gate {GOAL_RGB_AGREE})")
    # constant within an episode, and not the start view
    zero_counts()
    for p in plain_watch:
        p.start()
    st, obs = env.reset_fn()
    g0, rgb0 = obs["imagegoal"].clone(), obs["rgb"].clone()
    for t in range(env_size["steps"]):
        st, obs, _, done, _ = env.step_fn(st, torch.full((n,), 1 + t % 3, dtype=torch.int32, device=dev))
        if done.any() or not torch.equal(obs["imagegoal"], g0):
            fail(f"[imagenav] the goal image changed within an episode at step {t}")
    sync(dev)
    for p in plain_watch:
        p.stop()
    env_launches = path_counts("[imagenav] yaml env", raycast_fused_sel_t=1 + env_size["steps"])
    same_view = [i for i in range(n) if torch.equal(g0[i], rgb0[i])]
    if same_view:
        fail(f"[imagenav] envs {same_view}: the goal image is the start view")
    log(f"[imagenav] {gpu}: imagenav_procgen.yaml (N={n}, 128x128 RGB and goal images): {E} goal renders in "
        f"{table_launches['raycast_fused_sel_t']} #1 launch at table build ({build_s:.1f} s with the env); their "
        f"closest hit against #1's plain version: hit {hit_a:.6f} idx {idx_a:.6f} |dt| {dt:.3g}; goal RGB equal to "
        f"the plain render on the CPU on {rgb_eq:.6f} of pixels (gate {GOAL_RGB_AGREE}; the CPU render {cpu_s:.1f} s); "
        f"the goal image constant over {env_size['steps']} steps and unlike every start view; #1 launches "
        f"{env_launches['raycast_fused_sel_t']} = 1 reset + {env_size['steps']} steps")

    # (b) the train recipe: the rgb encoder and the goal encoder
    scenes, episodes, fields = make_procedural_pointnav(
        num_scenes=recipe["num_scenes"], episodes_per_scene=recipe["episodes_per_scene"], seed=recipe["seed"],
        extent=recipe["extent"])
    hw, N, T = recipe["hw"], recipe["num_envs"], ppo["num_steps"]
    zero_counts()
    for p in plain_watch:
        p.start()
    env = make_nav_env(scenes, episodes, num_envs=N, precomputed_fields=fields,
                       max_episode_steps=recipe["max_episode_steps"], goal_image_size=hw, device=dev,
                       sensor_specs=(("HabitatSimRGBSensor", {"height": hw, "width": hw}),
                                     ("ImageGoalSensor", {"height": hw, "width": hw}),
                                     ("CompassSensor", None), ("GPSSensor", None)))
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(env.num_actions, visual_inputs=("rgb",), input_hw=(hw, hw),
                                         backbone="resnet9", hidden_size=recipe["hidden_size"], goal_keys=(),
                                         **obs_inputs_of(env.observation_shapes), device=dev)
    lrn = PPOLearner(env, policy, PPOConfig(**ppo))
    rs, walls, roll, upd, metrics = recipe_run("[imagenav] recipe", lrn, updates, dev)
    sync(dev)
    for p in plain_watch:
        p.stop()
    # the goal table's render, the reset's and one per env step; one pool
    # backward per encoder (observation, goal) per minibatch of each epoch
    mb = ppo["ppo_epoch"] * ppo["num_mini_batch"]
    train = path_counts("[imagenav] recipe", raycast_fused_sel_t=2 + updates * T,
                        max_pool_3x3s2_bwd=2 * updates * mb)
    if plain_on_card:
        fail(f"[imagenav]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    if policy.net.image_goal_keys != ("imagegoal",):
        fail(f"[imagenav] the recipe's net encodes goals {policy.net.image_goal_keys}")
    act = torch.ones(N, dtype=torch.int32, device=dev)
    log(f"[imagenav] {gpu}: scripts/train_imagenav_tpu.py's recipe ({recipe['num_scenes']} scenes x "
        f"{recipe['episodes_per_scene']} episodes, N={N}, {hw}x{hw} RGB + {hw}x{hw} goal image through a second "
        f"encoder + compass + gps, resnet9 + LSTM-{recipe['hidden_size']}, goal_keys=(), PPO T={T}): "
        + recipe_text(N, T, walls, roll, upd, metrics)
        + f"; launches #1 {train['raycast_fused_sel_t']} = 1 goal table + 1 + {updates} x {T}, #11 "
        f"{train['max_pool_3x3s2_bwd']} = 2 encoders x {updates} x {ppo['ppo_epoch']} epochs x "
        f"{ppo['num_mini_batch']} minibatches; no plain version on a card tensor; "
        + idle_text(dev, env, rs.env_state, act)
        + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    return dict(table=table_launches, env=env_launches, train=train)


def pick_arm_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, recipe=ARM_RECIPE,
                   updates=RECIPE_UPDATES, ppo=RECIPE_PPO, visual=ARM_VISUAL, evaluation=ARM_EVAL):
    """[pick-arm]: (a) the blind arm-Pick recipe with the Gaussian policy
    (no kernel), one float32 update held to the CPU; (b) the visual
    Gaussian policy policy_from_config builds for pick_procgen.yaml with
    ArmAction/BaseVelAction, trained and evaluated. Returns the launch
    counts of (b)."""
    import dataclasses
    from types import SimpleNamespace

    import torch

    from habitat_torch.baselines.evaluator import evaluate_agent
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutBatch
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.models.policy import GaussianActorCritic, make_gaussian_resnet_policy, state_keys_of
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    zero_counts()
    for p in plain_watch:
        p.start()
    env = make_rearrange_env(device=dev, **recipe)
    N, T, A = recipe["num_envs"], ppo["num_steps"], env.action_dim
    keys = state_keys_of(env.observation_shapes)

    def blind_policy(device, dtype=torch.bfloat16):
        return make_gaussian_resnet_policy(A, backbone="resnet9", hidden_size=128, has_visual=False, goal_keys=(),
                                           state_keys=keys, dtype=dtype, device=device)

    torch.manual_seed(0)
    policy = blind_policy(dev)
    lrn = PPOLearner(env, policy, PPOConfig(**ppo), action_type="gaussian", measure_keys=("success", "pick_success"))
    rs, walls, roll, upd, metrics = recipe_run("[pick-arm] recipe", lrn, updates, dev)
    sync(dev)
    for p in plain_watch:
        p.stop()
    path_counts("[pick-arm] blind recipe")  # no kernel, as in the JAX package (with_visual=False)
    # one update from a fixed start and batch, card against CPU, float32,
    # one epoch of one minibatch (no permutation to draw)
    rs, batch, lv, h0, _ = lrn.collect_rollout(rs)
    start = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    check = PPOConfig(**{**ppo, "ppo_epoch": 1, "num_mini_batch": 1})

    def one_update(device):
        pol = blind_policy(device, torch.float32)
        pol.load_state_dict(start)
        stub = SimpleNamespace(num_envs=N, device=device, action_dim=A)
        lr_ = PPOLearner(stub, pol, check, action_type="gaussian")
        b = RolloutBatch(**{k: ({o: x.to(device) for o, x in v.items()} if k == "obs" else v.to(device))
                            for k, v in batch._asdict().items()})
        m = lr_.update(torch.Generator(device=device).manual_seed(0), b, lv.to(device), h0.to(device))
        return {k: v.item() for k, v in m.items()}, {k: v.cpu() for k, v in pol.state_dict().items()}

    m_card, p_card = one_update(dev)
    m_cpu, p_cpu = one_update(cpu)
    loss_err = {k: abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu}
    param_err = max((p_card[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
    if max(loss_err.values()) > LOSS_RTOL or param_err > 2 * ppo["lr"]:
        fail(f"[pick-arm] the float32 update, card against CPU: losses {loss_err}, parameters {param_err}")
    act = torch.zeros(N, A, device=dev)
    log(f"[pick-arm] {gpu}: scripts/train_pick_arm_tpu.py's recipe (N={N}, pick, {recipe['num_scenes']} scenes x "
        f"{recipe['episodes_per_scene']} episodes, blind, arm control, {A} continuous actions, Gaussian resnet9 net "
        f"without an encoder + LSTM-128 over {list(keys)}, PPO T={T}): " + recipe_text(N, T, walls, roll, upd, metrics)
        + f"; no kernel launched; one float32 update (1 epoch, 1 minibatch) from the rollout's start, card - CPU: "
        f"losses max rel {max(loss_err.values()):.3g} (gate {LOSS_RTOL}), parameters max {param_err:.3g} (gate "
        f"{2 * ppo['lr']}); log_std {policy.action_head.log_std.detach().mean().item():.4f}; "
        + idle_text(dev, env, rs.env_state, act))

    # (b) the visual Gaussian policy from the config
    cfg = get_config("benchmark/rearrange/pick_procgen.yaml", list(ARM_OVERRIDES))
    n, Tv, vu = visual["num_envs"], visual["ppo"]["num_steps"], visual["updates"]
    zero_counts()
    for p in plain_watch:
        p.start()
    env = construct.env_from_config(cfg, num_envs=n, device=dev)
    torch.manual_seed(0)
    policy = construct.policy_from_config(cfg, env)
    if not isinstance(policy, GaussianActorCritic) or policy.net.encoder is None or env.action_dim != A:
        fail(f"[pick-arm] policy_from_config built {type(policy).__name__} for a {env.action_dim}-wide action")
    lrn = PPOLearner(env, policy, PPOConfig(**visual["ppo"]), action_type="gaussian",
                     measure_keys=("success", "pick_success"))
    rs, walls, roll, upd, metrics = recipe_run("[pick-arm] visual", lrn, vu, dev)
    sync(dev)
    mb = visual["ppo"]["ppo_epoch"] * visual["ppo"]["num_mini_batch"]
    train = path_counts("[pick-arm] visual train", raycast_index_t=2 * (1 + vu * Tv), max_pool_3x3s2_bwd=vu * mb)
    # 8 deterministic episodes, one per env of an N=8 env from the same config
    ecfg = get_config("benchmark/rearrange/pick_procgen.yaml",
                      list(ARM_OVERRIDES) + [f"habitat.environment.max_episode_steps={evaluation['max_steps']}"])
    eval_env = construct.env_from_config(ecfg, num_envs=evaluation["num_envs"], device=dev)
    env_steps, step = [], eval_env.step_fn

    def counted(*a):
        env_steps.append(1)
        return step(*a)

    eval_env.step_fn = counted
    zero_counts()
    t0 = time.perf_counter()
    ev = evaluate_agent(eval_env, policy, episodes_per_env=1, deterministic=True, measure_keys=("success",))
    sync(dev)
    eval_s = time.perf_counter() - t0
    for p in plain_watch:
        p.stop()
    evl = path_counts("[pick-arm] visual eval", raycast_index_t=2 * (1 + len(env_steps)))
    if plain_on_card:
        fail(f"[pick-arm]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    if ev.get("num_episodes") != evaluation["num_envs"]:
        fail(f"[pick-arm] eval counted {ev.get('num_episodes')} episodes, want {evaluation['num_envs']}")
    h, w = env.observation_shapes["robot_head_depth"][0][:2]
    log(f"[pick-arm] {gpu}: policy_from_config for pick_procgen.yaml + ArmAction/BaseVelAction (N={n}, {h}x{w} head "
        f"depth + RGB, {env.capabilities[-1]}, {len(policy.net.encoder.backbone.blocks)}-block ResNet + "
        f"LSTM-{policy.net.hidden_size}, "
        f"Gaussian over {A}): " + recipe_text(n, Tv, walls, roll, upd, metrics)
        + f"; launches #3 {train['raycast_index_t']} = 2 per render x (1 + {vu} x {Tv}), #11 "
        f"{train['max_pool_3x3s2_bwd']} = {vu} x {mb}; evaluate_agent, deterministic (mu), N={evaluation['num_envs']}: "
        f"{ev['num_episodes']:.0f} episodes in {len(env_steps)} env steps, {eval_s:.1f} s, success {ev['success']:.3f}, "
        f"#3 {evl['raycast_index_t']} = 2 x (1 + {len(env_steps)}); no plain version on a card tensor; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(train=train, eval=evl)



def small_nav_env(dev, n, hw, rows=slice(None)):
    """2 procedural scenes x 8 episodes, ``hw`` x ``hw`` depth + pointgoal,
    episodes of at most 6 steps (some end inside an 8-step rollout);
    ``rows`` of the ``n`` envs."""
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=8, seed=0)
    return make_nav_env(scenes, episodes, num_envs=n, device=dev, precomputed_fields=fields, max_episode_steps=6,
                        sensor_specs=(("HabitatSimDepthSensor", {"height": hw, "width": hw}),
                                      ("PointGoalWithGPSCompassSensor", None)), rows=rows)


def ddppo_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, n=DDPPO["num_envs"],
                updates=DDPPO["updates"], overrides=()):
    """[ddppo]: run.main on ddppo_pointnav.yaml (resnet50 + LSTM-512x2,
    128x128 depth, T=128, 2 epochs of 2 minibatches) at N=``n`` under a
    process group of one rank (NCCL on the card, gloo on the CPU), for
    ``updates`` updates: seconds per update, rollout / update split,
    env-steps/s, peak memory; #1 and #11 launched exactly; finite losses.
    Returns the launch counts."""
    import tempfile

    import numpy as np
    import torch

    from habitat_torch.baselines import run
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.models.resnet import Bottleneck
    from habitat_torch.parallel import distributed

    t_phase = time.perf_counter()
    cfg = get_config(DDPPO_EXPERIMENT, list(overrides))
    p = cfg.habitat_baselines.rl.ppo
    T, mb = int(p.num_steps), int(p.ppo_epoch) * int(p.num_mini_batch)
    trainers, split = [], {"rollout": [], "update": []}
    build = construct.trainer_from_config

    def timed(name, fn):
        def call(*a, **k):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def kept(*a, **k):
        tr = build(*a, **k)
        tr.learner.collect_rollout = timed("rollout", tr.learner.collect_rollout)
        tr.learner.update = timed("update", tr.learner.update)
        trainers.append(tr)
        return tr

    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(construct, "trainer_from_config", kept):
        distributed.init_distributed(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            w = distributed.world()
            backend = torch.distributed.get_backend()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            zero_counts()
            for pw in plain_watch:
                pw.start()
            t0 = time.perf_counter()
            args = [f"--config-name={DDPPO_EXPERIMENT}", *(["--device", "cpu"] if dev.type == "cpu" else []),
                    *overrides, f"habitat_baselines.num_environments={n}",
                    f"habitat_baselines.total_num_steps={updates * n * T}",
                    f"habitat_baselines.checkpoint_folder={tmp}/ckpt", "habitat_baselines.tensorboard_dir=",
                    "habitat_baselines.log_interval=1"]
            metrics = run.main(args)
            sync(dev)
            wall = time.perf_counter() - t0
            for pw in plain_watch:
                pw.stop()
            got = path_counts("[ddppo] run.main", raycast_fused_sel_t=1 + updates * T,
                              max_pool_3x3s2_bwd=updates * mb)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else float("nan")
        finally:
            distributed.abort()
    if plain_on_card:
        fail(f"[ddppo]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    tr = trainers[-1]
    net = tr.policy.net
    if not (w.active and w.size == 1 and tr.run_cfg.use_mesh and len(net.encoder.backbone.blocks) == 16
            and isinstance(net.encoder.backbone.blocks[0], Bottleneck) and net.num_recurrent_layers == 2
            and net.hidden_size == 512 and tr.num_updates_done == updates):
        fail(f"[ddppo] built or ran something else: world {w}, {tr.num_updates_done} updates")
    losses = {k: v for k, v in metrics.items() if k.startswith("losses/")}
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        fail(f"[ddppo] losses {losses}")
    roll, upd = split["rollout"], split["update"]
    per_update = [(r + u) / 1e3 for r, u in zip(roll, upd)]
    rates = [n * T / s for s in per_update]
    h, w_ = tr.env.observation_shapes["depth"][0][:2]
    log(f"[ddppo] {gpu}: run.main {DDPPO_EXPERIMENT} under {backend} at world size 1, N={n} ({h}x{w_} depth, "
        f"resnet50 base 32 / 16 groups, LSTM-512 x 2, T={T}, {mb} minibatch steps per update): {updates} updates "
        f"in {wall:.1f} s; ms per update (rollout + update; the first with the warm-up) "
        f"{[round(x * 1e3, 1) for x in per_update]}, rollout ms {[round(x, 1) for x in roll]}, update ms "
        f"{[round(x, 1) for x in upd]}; train env-steps/s {[round(r, 1) for r in rates]}; peak memory "
        f"{peak:.2f} GiB; launches #1 {got['raycast_fused_sel_t']} = 1 + {updates} x {T}, #11 "
        f"{got['max_pool_3x3s2_bwd']} = {updates} x {mb}; no plain version on a card tensor; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()) + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    return got


def two_rank_policy(dev, visual):
    import torch

    from habitat_torch.models.policy import make_pointnav_resnet_policy

    c = DDPPO_2RANK
    torch.manual_seed(0)
    return make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(c["hw"], c["hw"]), backbone="resnet18",
                                       hidden_size=c["hidden"], has_visual=visual, dtype=torch.float32, device=dev)


def two_rank_step(dev, visual):
    """``init(seed=0)`` and one train step of the [ddppo-2rank] config on
    this process's rows (all of them without a group): the parameters."""
    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.parallel import distributed

    c = DDPPO_2RANK
    rows = distributed.env_rows(c["num_envs"])
    lrn = PPOLearner(small_nav_env(dev, c["num_envs"], c["hw"], rows.slice), two_rank_policy(dev, visual),
                     PPOConfig(**c["ppo"]), rows=rows)
    with cudnn_deterministic(True):
        lrn.train_step(lrn.init(seed=0))
    return {k: v.detach().cpu() for k, v in lrn.policy.state_dict().items()}


def ddppo_rank_main(rank, folder, device):
    """One rank of [ddppo-2rank] (``chip_smoke.py --ddppo-rank RANK FOLDER
    DEVICE``): gloo over DEVICE's tensors (cuda:0 on the card), through a
    file store in FOLDER; the kernels load from the parent's build."""
    import torch

    from habitat_torch.parallel import distributed

    dev = distributed.init_distributed(f"file://{folder}/store", 2, rank, device=device, backend="gloo",
                                       timeout_s=300)
    out = {kind: two_rank_step(dev, kind == "visual") for kind in ("blind", "visual")}
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    distributed.abort()
    return 0


def ddppo_two_rank_phase(gpu, dev):
    """[ddppo-2rank]: two processes on the card over gloo, each with N/2
    envs of a small resnet18 PointNav config (64x64 depth, LSTM-128,
    float32, cuDNN deterministic), one train step, held to the same step in
    one process on the card: the ranks' parameters bit-equal; every element
    of both nets within DDPPO_RTOL / DDPPO_ATOL; every trained tensor
    moved."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    c = DDPPO_2RANK
    steps = c["ppo"]["ppo_epoch"] * c["ppo"]["num_mini_batch"]
    with tempfile.TemporaryDirectory() as tmp:
        where = "cuda:0" if dev.type == "cuda" else "cpu"
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddppo-rank", str(r), tmp, where],
                                  cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                p.kill()
        if any(p.returncode for p in procs):
            fail(f"[ddppo-2rank] ranks exited {[p.returncode for p in procs]}: "
                 + " | ".join(err[-1500:] for _, err in outs))
        two = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True) for r in range(2)]
    worker_s = time.perf_counter() - t_phase
    text = []
    for kind in ("blind", "visual"):
        one = two_rank_step(dev, kind == "visual")
        start = {k: v.detach().cpu() for k, v in two_rank_policy(dev, kind == "visual").state_dict().items()}
        a, b = two[0][kind], two[1][kind]
        if not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"[ddppo-2rank] {kind}: the ranks' parameters differ")
        # every trained tensor moved (the LSTM's bias_ih is frozen, as in Flax)
        still = [k for k in one if not k.endswith("bias_ih") and torch.equal(one[k], start[k])]
        d = torch.cat([(a[k] - v).abs().flatten() for k, v in one.items()])
        out = d > DDPPO_ATOL + DDPPO_RTOL * torch.cat([v.abs().flatten() for v in one.values()])
        worst, bad = d.max().item(), int(out.sum())
        if still or bad:
            fail(f"[ddppo-2rank] {kind}: max |2 ranks - 1| {worst:.3g}, {bad} of {d.numel()} elements beyond "
                 f"rtol {DDPPO_RTOL} / atol {DDPPO_ATOL}, unmoved {still}")
        text.append(f"{kind}: {len(one)} tensors, max |2 ranks - 1| {worst:.3g}, {bad} of {d.numel()} elements "
                    f"beyond rtol/atol")
    log(f"[ddppo-2rank] {gpu}: 2 processes on {where} over gloo, N={c['num_envs']} as 2 x "
        f"{c['num_envs'] // 2}, {c['hw']}x{c['hw']} depth, resnet18 / blind + LSTM-{c['hidden']}, float32, one train "
        f"step (T={c['ppo']['num_steps']}, {steps} Adam steps) against one process on {where}: ranks bit-equal; "
        + "; ".join(text) + f"; workers {worker_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s")


def bench_nav_env(dev, n, hw=None, **kw):
    """An env over the bench scenes (4 procedural scenes x 16 episodes, seed
    0): hw x hw depth + RGB + pointgoal, or the pointgoal alone (hw None)."""
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    sensors = (("PointGoalWithGPSCompassSensor", None),)
    if hw:
        sensors = (("HabitatSimDepthSensor", {"height": hw, "width": hw}),
                   ("HabitatSimRGBSensor", {"height": hw, "width": hw})) + sensors
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    return make_nav_env(scenes, episodes, num_envs=n, precomputed_fields=fields, sensor_specs=sensors, device=dev,
                        **kw)


def bc_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[bc]: behavior cloning of the geodesic follower at the bench's widths
    (BC) on the card: a warm-up and BC_UPDATES timed updates (ms split into
    the rollout, env + teacher, and the update; env-steps/s; peak memory;
    the teacher's ms and launches per env step; idle share and launches of
    one profiled update). Gates: #1 launched 1 + T per update, #11 once per
    update, no plain version on a card tensor; #11 bit-equal to its plain
    version on the path's last stem-pool input; tests/test_il.py's learning
    gate (BC_GATE) from its initial weights; one float32 update (BC_CHECK)
    on the card against the CPU from the same weights and env state:
    teacher actions equal at every env and step, losses within SWITCH_RTOL
    relative, parameters by [check]'s per-tensor share rule at BC's lr.
    Returns the train path's launch counts and the #11 check."""
    import numpy as np
    import torch

    from habitat_torch.baselines.il.bc_trainer import BCConfig, BCLearner
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.convert import load_policy_file
    from habitat_torch.models.policy import make_pointnav_resnet_policy
    from habitat_torch.ops import pool

    t_phase = time.perf_counter()
    N, T = BC["num_envs"], BC["num_steps"]
    env = bench_nav_env(dev, N, BENCH["height"], max_episode_steps=500)
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(len(env.actions), backbone="resnet18", hidden_size=512,
                                         input_hw=(BENCH["height"], BENCH["width"]), device=dev)
    lrn = BCLearner(env, policy, BCConfig(num_steps=T))
    split = {"rollout": [], "update": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lrn.collect_rollout = timed("rollout", lrn.collect_rollout)
    lrn.update = timed("update", lrn.update)
    updates = 1 + BC_UPDATES
    pool_backward, last_bwd = pool._MaxPool3x3s2.backward, {}

    def backward_seen(ctx, dy):
        gx = pool_backward(ctx, dy)
        if pool.max_pool_3x3s2_bwd.launches == updates:
            x, y = ctx.saved_tensors
            last_bwd["args"] = (x, y, dy.contiguous(memory_format=torch.channels_last))
        return gx

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for p in plain_watch:
        p.start()
    st = lrn.init()
    walls = []
    with mock.patch.object(pool._MaxPool3x3s2, "backward", staticmethod(backward_seen)):
        for i in range(updates):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, metrics = lrn.train_step(st)
            metrics = {k: v.item() for k, v in metrics.items()}
            if i:
                walls.append(time.perf_counter() - t0)
            if not all(np.isfinite(v) for v in metrics.values()):
                fail(f"[bc] non-finite metrics {metrics}")
    torch.cuda.synchronize()
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[bc]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    peak = torch.cuda.max_memory_allocated()
    launches = path_counts("bc train path", raycast_fused_sel_t=1 + updates * T, max_pool_3x3s2_bwd=updates)
    del lrn.collect_rollout, lrn.update
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    roll, upd = split["rollout"][1:], split["update"][1:]
    rates = sorted(N * T / w for w in walls)
    # the teacher alone on the last state: ms and launches per env step
    teacher_ms = cuda_ms(lambda: lrn.teacher(st.env_state), 10)
    _, t_dev_ms, t_launch, _ = device_time_and_launches(lambda: [lrn.teacher(st.env_state) for _ in range(3)])
    # one profiled update: device time and launches; the idle share against
    # the unprofiled updates' median wall (the profiler slows the host)
    (st, _), dev_ms, n_launch, top = device_time_and_launches(lambda: lrn.train_step(st))
    log(f"[bc] {gpu}: behavior cloning N={N} T={T} ({N * T} frames per update), {BENCH['height']}x{BENCH['width']} depth+RGB, resnet18 + "
        f"LSTM-512 bf16: ms per update {[round(w * 1e3, 1) for w in walls]} (median {med(walls) * 1e3:.1f}) = "
        f"rollout (env + teacher) {[round(x, 1) for x in roll]} + update {[round(x, 1) for x in upd]} (warm-up "
        f"{split['rollout'][0]:.1f} + {split['update'][0]:.1f}); env-steps/s median {rates[len(rates) // 2]:.1f} "
        f"(min {rates[0]:.1f}, max {rates[-1]:.1f}); peak memory {peak / 2**30:.2f} GiB; teacher {teacher_ms:.3f} ms "
        f"and {t_launch / 3:.0f} launches per env step (device {t_dev_ms / 3:.3f} ms); one profiled update: device "
        f"{dev_ms:.1f} ms, idle share {1 - dev_ms / (med(walls) * 1e3):.3f} of the median update, {n_launch} launches; "
        f"last metrics " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
        + f"; launches {launches} (#1 1 + {T} per update, #11 one per update), no plain version on a card tensor")
    for e in top[:4]:
        log(f"[bc]   {device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")

    # #11 on the path's own input: the stem output of the last update
    x, y, dy = last_bwd.pop("args")
    mb_shape = (N * T, 32, BENCH["height"] // 2, BENCH["width"] // 2)
    if tuple(x.shape) != mb_shape or x.dtype != torch.bfloat16:
        fail(f"[bc] the pool backward got {tuple(x.shape)} {x.dtype}, want {mb_shape} bfloat16")
    _, pool_err = pool_check(f"[bc] update {mb_shape}", (x, y, dy))
    del x, y, dy, lrn, policy, st
    torch.cuda.empty_cache()

    # tests/test_il.py's learning gate, from its initial weights
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=6, seed=5, extent=8.0)
    genv = make_nav_env(scenes, episodes, num_envs=8, precomputed_fields=fields, max_episode_steps=100, device=dev)
    glrn = BCLearner(genv, load_policy_file(os.path.join(ROOT, BC_GATE_WEIGHTS), device=dev),
                     BCConfig(num_steps=32, lr=BC_GATE["lr"]))
    gst, match = glrn.init(), []
    t0 = time.perf_counter()
    for _ in range(BC_GATE["updates"]):
        gst, m = glrn.train_step(gst)
        match.append(m["teacher_match"].item())
    first, last = float(np.mean(match[:5])), float(np.mean(match[-5:]))
    gate_s = time.perf_counter() - t0
    if not (last > first + BC_GATE["rise"] and last > BC_GATE["final"]):
        fail(f"[bc] learning gate: teacher_match {first:.4f} over the first 5 updates, {last:.4f} over the last 5")

    # one float32 update, card against CPU, from the same weights and state
    res = {}
    torch.manual_seed(0)
    start = make_pointnav_resnet_policy(4, has_visual=False, hidden_size=BC_CHECK["hidden"], dtype=torch.float32,
                                        device="cpu").state_dict()
    for d in (dev, torch.device("cpu")):
        e = bench_nav_env(d, BC_CHECK["num_envs"], max_episode_steps=20)
        pol = make_pointnav_resnet_policy(4, has_visual=False, hidden_size=BC_CHECK["hidden"], dtype=torch.float32,
                                          device=d)
        pol.load_state_dict(start)
        cl = BCLearner(e, pol, BCConfig(num_steps=T))
        _, batch = cl.collect_rollout(cl.init())
        m, _ = cl.update(batch)
        res[d.type] = (batch["teacher"].cpu(), {k: v.item() for k, v in m.items()},
                       {k: v.detach().cpu() for k, v in pol.state_dict().items()})
    (t_card, m_card, p_card), (t_cpu, m_cpu, p_cpu) = res[dev.type], res["cpu"]
    loss_err = abs(m_card["losses/bc_loss"] - m_cpu["losses/bc_loss"]) / max(1.0, abs(m_cpu["losses/bc_loss"]))
    rows, bad = share_gate(start, p_card, p_cpu, BCConfig().lr)
    if not torch.equal(t_card, t_cpu) or loss_err > SWITCH_RTOL or bad:
        fail(f"[bc] float32 update, card against CPU: teachers differ at {int((t_card != t_cpu).sum())} of "
             f"{t_cpu.numel()}, loss {loss_err:.3g} relative, tensors below the share: {bad} ({gap_trace(rows)})")
    log(f"[bc] {gpu}: learning gate (tests/test_il.py, {BC_GATE['updates']} updates from {BC_GATE_WEIGHTS}): "
        f"teacher_match {first:.4f} -> {last:.4f} (rise > {BC_GATE['rise']}, end > {BC_GATE['final']}) in "
        f"{gate_s:.1f} s; #11 on the last update's own input bit-equal to its plain version; float32 update (blind "
        f"LSTM-{BC_CHECK['hidden']}, N={BC_CHECK['num_envs']}, T={T}) card against CPU: teachers equal at all "
        f"{t_cpu.numel()}, loss {loss_err:.3g} relative, least share {min(r[0] for r in rows.values()):.4f}, beyond "
        f"lr/10: {gap_trace(rows)}; the phase {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(shape=list(mb_shape), max_abs_err=pool_err)


def hrl_rollout_success(env, hl, steps):
    """(N,) bool: the envs with a successful episode within ``steps`` steps
    of the hierarchy over ``hl``, on the CPU; and the seconds it took."""
    import torch

    from habitat_torch.baselines.hrl.hierarchical import HierarchicalPolicy

    pol = HierarchicalPolicy(env, hl)
    st, _ = env.reset_fn()
    t0 = time.perf_counter()
    _, _, _, _, succ = pol.rollout(st, pol.init_state(), steps)
    solved = (succ.max(0).values > 0).cpu()
    return solved, time.perf_counter() - t0


def hrl_phase(gpu, dev, zero_counts, path_counts):
    """[hrl]: HRL-PPO at scripts/train_hrl_tpu.py's configuration (HRL_ENV,
    HRL_PPO, the four oracle skills) on the card: a warm-up and HRL_UPDATES
    timed updates (ms per update, env-steps/s; launches, device time and
    idle share per env step from 3 profiled env steps with the skills'
    actions); no kernel launches (state only). Gates: on their tests' env
    (HRL_RULE_ENV) the plan-table planner (HRL_PLANNER) and the fixed plan
    (HRL_FIXED) complete a successful episode in their shares of envs; at
    N=128 on [hrl]'s env the planner solves the same envs on the card as on
    the CPU; at N=8 from one state the
    card and the CPU agree on every step's skill index and action of a
    100-step planner rollout, and one HRL-PPO train step with the same
    draws gives losses within SWITCH_RTOL relative and parameters by the
    per-tensor share rule; run.main on an HRL experiment config builds the
    trainer on the card and takes 2 updates."""
    import tempfile

    import numpy as np
    import torch

    from habitat_torch.baselines import run
    from habitat_torch.baselines.hrl.hierarchical import (
        FixedHighLevelPolicy,
        HierarchicalPolicy,
        default_rearrange_plan,
        skill_actions,
    )
    from habitat_torch.baselines.hrl.hrl_ppo import HrlPPOConfig, HrlPPOLearner, HrlTrainer
    from habitat_torch.baselines.hrl.planner import PlannerHighLevelPolicy
    from habitat_torch.core import construct
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    N = HRL_ENV["num_envs"]
    env = make_rearrange_env(device=dev, **HRL_ENV)
    torch.manual_seed(0)
    lrn = HrlPPOLearner(env, default_rearrange_plan(), HrlPPOConfig(**HRL_PPO))
    per_update = N * HRL_PPO["num_macro_steps"] * HRL_PPO["hl_interval"]
    zero_counts()
    ts = lrn.init(seed=0)
    walls = []
    for i in range(1 + HRL_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, metrics = lrn.train_step(ts)
        metrics = {k: v.item() for k, v in metrics.items()}
        if i:
            walls.append(time.perf_counter() - t0)
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"[hrl] non-finite metrics {metrics}")
    path_counts("hrl train path")
    # one env step with the skills' actions, profiled
    skill = torch.zeros(N, dtype=torch.int64, device=dev)
    st = ts.env_state

    def env_step():
        return env.step_fn(st, skill_actions(env, lrn.skills, st, skill))

    step_ms = cuda_ms(env_step, 5)
    _, dev_ms, n_launch, _ = device_time_and_launches(lambda: [env_step() for _ in range(3)])
    rates = sorted(per_update / w for w in walls)
    log(f"[hrl] {gpu}: HRL-PPO N={N}, {HRL_PPO['num_macro_steps']} macro steps x {HRL_PPO['hl_interval']} env "
        f"steps, hidden {HRL_PPO['hidden_size']}: ms per update {[round(w * 1e3, 1) for w in walls]}, env-steps/s "
        f"median {rates[len(rates) // 2]:.1f} (min {rates[0]:.1f}, max {rates[-1]:.1f}); an env step with the four "
        f"skills' actions {step_ms:.3f} ms, {n_launch / 3:.0f} launches, device {dev_ms / 3:.3f} ms, idle share "
        f"{1 - dev_ms / (3 * step_ms):.3f}; last metrics " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
        + "; no kernel launched")

    # the planner's and the fixed plan's rules on their tests' env, then the
    # planner at N=128 on the card against the CPU, env by env
    solved, secs = {}, {}
    genv = make_rearrange_env(device=dev, **HRL_RULE_ENV)
    for name, hl, steps in (("planner", PlannerHighLevelPolicy(genv), HRL_PLANNER["steps"]),
                            ("fixed", FixedHighLevelPolicy(genv, default_rearrange_plan()), HRL_FIXED["steps"])):
        solved[name], secs[name] = hrl_rollout_success(genv, hl, steps)
    for d in (dev.type, "cpu"):
        genv = make_rearrange_env(device=d, **{**HRL_ENV, "max_episode_steps": HRL_PLANNER_N128})
        solved[d], secs[d] = hrl_rollout_success(genv, PlannerHighLevelPolicy(genv), HRL_PLANNER_N128)
    rule = {name: share(solved[name]) for name in ("planner", "fixed")}
    parted_envs = int((solved[dev.type] != solved["cpu"]).sum())
    if rule["planner"] < HRL_PLANNER["share"] or rule["fixed"] < HRL_FIXED["share"] or parted_envs:
        fail(f"[hrl] envs with a successful episode: the tests' rules {rule}; at N={N} the planner's card "
             f"{share(solved[dev.type])}, CPU {share(solved['cpu'])}, {parted_envs} envs part")

    # card against CPU at N=8 from one state
    n = HRL_CHECK["num_envs"]
    envs = {d: make_rearrange_env(device=d, **{**HRL_ENV, "num_envs": n}) for d in ("cpu", dev.type)}
    pols = {d: HierarchicalPolicy(e, PlannerHighLevelPolicy(e)) for d, e in envs.items()}
    sts = {d: e.reset_fn()[0] for d, e in envs.items()}
    hls = {d: p.init_state() for d, p in pols.items()}
    parted = []
    for t in range(HRL_CHECK["steps"]):
        out = {}
        for d in envs:
            act, hls[d] = pols[d].act(hls[d], sts[d])
            sts[d], _, _, done, _ = envs[d].step_fn(sts[d], act)
            out[d] = (act.cpu(), hls[d].skill_idx.cpu(), done.cpu())
            hls[d].skill_idx = torch.where(done, 0, hls[d].skill_idx)
        if not all(torch.equal(a, b) for a, b in zip(out["cpu"], out[dev.type])):
            parted.append(t)
    cfg = HrlPPOConfig(**HRL_CHECK["ppo"])
    g = torch.Generator().manual_seed(0)
    draws = torch.randint(0, 4, (cfg.num_macro_steps, n), generator=g)
    torch.manual_seed(0)
    start = HrlPPOLearner(envs["cpu"], default_rearrange_plan(), cfg).net.state_dict()
    res = {}
    for d, e in envs.items():
        cl = HrlPPOLearner(e, default_rearrange_plan(), cfg)
        cl.net.load_state_dict(start)
        _, m = cl.train_step(cl.init(), skills=draws.to(e.device))
        res[d] = {k: v.item() for k, v in m.items()}, {k: v.detach().cpu() for k, v in cl.net.state_dict().items()}
    (m_card, p_card), (m_cpu, p_cpu) = res[dev.type], res["cpu"]
    loss_err = {k: abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu if k.startswith("losses/")}
    rows, bad = share_gate(start, p_card, p_cpu, cfg.lr)
    if parted or max(loss_err.values()) > SWITCH_RTOL or bad or m_card["done_count"] != m_cpu["done_count"]:
        fail(f"[hrl] card against CPU: planner steps that part {parted}; HRL-PPO losses {loss_err}, done counts "
             f"{m_card['done_count']} / {m_cpu['done_count']}, tensors below the share: {bad} ({gap_trace(rows)})")

    # run.main on an HRL experiment config, 2 updates
    trainers = []
    build = construct.trainer_from_config

    def kept(*a, **k):
        trainers.append(build(*a, **k))
        return trainers[-1]

    steps = 2 * HRL_CONFIG_ENVS * 16 * 8
    with tempfile.TemporaryDirectory() as tmp, mock.patch.object(construct, "trainer_from_config", kept):
        path = os.path.join(tmp, "rl_hierarchical.yaml")
        with open(path, "w") as f:
            f.write("# @package _global_\ndefaults:\n  - /benchmark/rearrange: pick_procgen\n"
                    "  - /habitat_baselines: habitat_baselines_rl_config_base\n  - _self_\n"
                    f"habitat_baselines:\n  updater_name: HRLPPO\n  num_environments: {HRL_CONFIG_ENVS}\n"
                    f"  total_num_steps: {steps}\n  log_interval: 1\n  tensorboard_dir: ''\n"
                    "  rl:\n    policy:\n      main_agent:\n        hierarchical_policy:\n"
                    "          defined_skills:\n" + "".join(f"            {k}: {{}}\n" for k in HRL_CONFIG_SKILLS))
        t0 = time.perf_counter()
        cm = run.main([f"--config-name={path}", "habitat.simulator.tpu.dynamics=kinematic"])
        torch.cuda.synchronize()
        config_s = time.perf_counter() - t0
    trainer = trainers[-1]
    if (not isinstance(trainer, HrlTrainer) or trainer.env.device.type != dev.type or trainer.num_updates_done != 2
            or trainer.env.control != "discrete" or not np.isfinite(cm["losses/hl_loss"])):
        fail(f"[hrl] run.main on the HRL config: {type(trainer).__name__} on {trainer.env.device}, "
             f"{getattr(trainer, 'num_updates_done', None)} updates, metrics {cm}")
    log(f"[hrl] {gpu}: envs with a successful episode, the tests' rules (N={HRL_RULE_ENV['num_envs']}, seed "
        f"{HRL_RULE_ENV['seed']}): plan-table planner {rule['planner']:.4f} in {HRL_PLANNER['steps']} steps (gate "
        f"{HRL_PLANNER['share']}), fixed plan {rule['fixed']:.4f} in {HRL_FIXED['steps']} (gate {HRL_FIXED['share']}), "
        f"{secs['planner']:.1f} + {secs['fixed']:.1f} s; the planner at N={N} on [hrl]'s env (episodes of up to "
        f"{HRL_PLANNER_N128} steps) {share(solved[dev.type]):.4f} in {secs[dev.type]:.1f} s, the same envs as the "
        f"CPU's ({secs['cpu']:.1f} s); card against CPU at N={n}: skill index and action equal at "
        f"all {HRL_CHECK['steps']} planner steps, one HRL-PPO update with the same draws: losses max rel "
        f"{max(loss_err.values()):.3g}, least share {min(r[0] for r in rows.values()):.4f}, beyond lr/10: "
        f"{gap_trace(rows)}; run.main on an HRL experiment (pick_procgen.yaml + updater HRLPPO, N={HRL_CONFIG_ENVS}): "
        f"{trainer.num_updates_done} updates on the card in {config_s:.1f} s, skills "
        f"{[type(s).__name__ for s in trainer.learner.skills]}; the phase {time.perf_counter() - t_phase:.1f} s")


def share_gate(start, a, b, lr):
    """Parameters after the same update from ``start`` on two devices: per
    tensor, (the share of elements whose changes agree within lr/10, how
    many do not, its size, the largest gap); and the tensors whose share is
    below UPDATE_TENSOR_SHARE."""
    rows = {}
    for k in start:
        d = (a[k] - b[k]).abs()
        rows[k] = (share(d <= lr / 10), int((d > lr / 10).sum().item()), d.numel(), d.max().item())
    return rows, [k for k, r in rows.items() if r[0] < UPDATE_TENSOR_SHARE]


def gap_trace(rows, top=4):
    """The tensors with elements beyond lr/10, most first, for the log."""
    worst = sorted((r for r in rows.items() if r[1][1]), key=lambda r: -r[1][1])[:top]
    return ", ".join(f"{k} {r[1]}/{r[2]} beyond (max {r[3]:.3g}, share {r[0]:.4f})" for k, r in worst) or "none"


def ppo_switches_phase(gpu, dev, n_env=SWITCH_ENV["num_envs"]):
    """[ppo-switches]: one update on the card against the same update on the
    CPU (float32, the same start, batch and permutations): loss terms within
    SWITCH_RTOL of max(1, |x|), and each tensor's share of elements whose
    change agrees within lr/10 at least UPDATE_TENSOR_SHARE ([check]'s rule);
    (a) normalized advantage + linear LR decay (total_updates=2); (b) the
    blind Gaussian arm-Pick net with the adaptive entropy coefficient
    (log_alpha moves, inside [log 1e-4, 0], equal on both); (c) CPC|A on a
    GRU policy (resnet9 over depth, GRU-128). The tensors with elements
    beyond lr/10 are logged. A planted fault, the CPU update again with
    the action head's gradient perturbed by noise of its own scale, must
    fail the share rule in each case."""
    import math
    from types import SimpleNamespace

    import torch

    from habitat_torch.baselines.aux_losses import CPCA
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutBatch
    from habitat_torch.models.policy import make_gaussian_resnet_policy, make_pointnav_resnet_policy, state_keys_of
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    c = SWITCH_ENV
    T, E, M = c["ppo"]["num_steps"], c["ppo"]["ppo_epoch"], c["ppo"]["num_mini_batch"]
    g = torch.Generator().manual_seed(0)
    perms = torch.stack([torch.randperm(n_env, generator=g) for _ in range(E)])
    time_perms = torch.stack([torch.stack([torch.randperm(T, generator=g) for _ in range(M)]) for _ in range(E)])
    nav = small_nav_env(dev, n_env, c["hw"])
    arm = make_rearrange_env(num_envs=n_env, task="pick", num_scenes=1, episodes_per_scene=8, seed=0,
                             with_visual=False, n_rooms_per_axis=1, n_clutter=0, max_episode_steps=6, control="arm",
                             device=dev)
    arm_keys = state_keys_of(arm.observation_shapes)
    A = arm.action_dim
    cases = {
        "normalized advantage + linear LR decay": dict(
            env=nav, cfg=dict(use_normalized_advantage=True, use_linear_lr_decay=True), total_updates=2,
            policy=lambda d: make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(c["hw"], c["hw"]),
                                                         backbone="resnet9", hidden_size=c["hidden"],
                                                         dtype=torch.float32, device=d)),
        "adaptive entropy (Gaussian arm Pick)": dict(
            env=arm, cfg=dict(use_adaptive_entropy_pen=True, entropy_target_factor=-2.0), action_type="gaussian",
            policy=lambda d: make_gaussian_resnet_policy(A, backbone="resnet9", hidden_size=c["hidden"],
                                                         has_visual=False, state_keys=arm_keys, dtype=torch.float32,
                                                         device=d)),
        "CPC|A on a GRU policy": dict(
            env=nav, cfg={}, aux=True,
            policy=lambda d: make_pointnav_resnet_policy(4, visual_inputs=("depth",), input_hw=(c["hw"], c["hw"]),
                                                         backbone="resnet9", hidden_size=c["hidden"], rnn_type="GRU",
                                                         dtype=torch.float32, device=d)),
    }
    text = []
    for name, case in cases.items():
        cfg = PPOConfig(**c["ppo"], **case["cfg"])
        at = case.get("action_type", "categorical")

        def learner(d, policy=None):
            torch.manual_seed(0)
            pol = policy or case["policy"](d)
            aux = CPCA(c["hidden"], c["hidden"]).to(d) if case.get("aux") else None
            env = case["env"] if d == dev else SimpleNamespace(num_envs=n_env, device=d,
                                                                action_dim=getattr(case["env"], "action_dim", None))
            return PPOLearner(env, pol, cfg, action_type=at, total_updates=case.get("total_updates"), aux_loss=aux)

        lrn = learner(dev)
        rs = lrn.init(seed=0)
        _, batch, lv, h0, _ = lrn.collect_rollout(rs)
        start = {k: v.detach().cpu().clone() for k, v in lrn.policy.state_dict().items()}
        aux_start = {k: v.detach().cpu().clone() for k, v in lrn.aux_loss.state_dict().items()} if lrn.aux_loss else {}

        def update(d, fault=False):
            ld = learner(d)
            ld.policy.load_state_dict(start)
            if ld.aux_loss is not None:
                ld.aux_loss.load_state_dict(aux_start)
            if fault:
                noise = torch.Generator(device=d).manual_seed(1)
                ld.policy.action_head.weight.register_hook(
                    lambda grad: grad + torch.randn(grad.shape, generator=noise, device=d) * grad.std())
            la = torch.full((), math.log(cfg.entropy_coef), device=d)
            b = RolloutBatch(**{k: ({o: x.to(d) for o, x in v.items()} if k == "obs" else v.to(d))
                                for k, v in batch._asdict().items()})
            with cudnn_deterministic(True):
                m = ld.update(torch.Generator(device=d).manual_seed(0), b, lv.to(d), h0.to(d), log_alpha=la,
                              perms=perms.to(d), time_perms=time_perms.to(d) if ld.aux_loss else None)
            params = {k: v.cpu() for k, v in ld.policy.state_dict().items()}
            if ld.aux_loss is not None:
                params.update({f"aux.{k}": v.cpu() for k, v in ld.aux_loss.state_dict().items()})
            return {k: v.item() for k, v in m.items()}, params, la.item(), ld

        (m_card, p_card, la_card, l_card), (m_cpu, p_cpu, la_cpu, _) = update(dev), update(cpu)
        start_all = {**start, **{f"aux.{k}": v for k, v in aux_start.items()}}
        loss_err = {k: abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu if k.startswith("losses/")}
        rows, bad = share_gate(start_all, p_card, p_cpu, cfg.lr)
        _, planted, _, _ = update(cpu, fault=True)
        _, caught = share_gate(start_all, p_card, planted, cfg.lr)
        param_err = max(r[3] for r in rows.values())
        if max(loss_err.values()) > SWITCH_RTOL or bad:
            fail(f"[ppo-switches] {name}, card against CPU: losses {loss_err}; tensors below the share "
                 f"{UPDATE_TENSOR_SHARE}: {bad} ({gap_trace(rows)})")
        if "action_head.weight" not in caught:
            fail(f"[ppo-switches] {name}: the share rule flags {caught}, not action_head.weight, after a fault "
                 "planted in its gradient")
        extra = ""
        if l_card.adaptive_ent:
            lo = math.log(1e-4)
            if not (abs(la_card - la_cpu) < 1e-6 and lo <= la_card <= 0.0
                    and abs(la_card - math.log(cfg.entropy_coef)) > 1e-5 and "losses/entropy_coef" in m_card):
                fail(f"[ppo-switches] {name}: log_alpha card {la_card} CPU {la_cpu} from {math.log(cfg.entropy_coef)}")
            extra = f", log_alpha {math.log(cfg.entropy_coef):.6f} -> {la_card:.6f} (CPU {la_cpu:.6f})"
        if l_card.lr_decay_steps:
            extra += f", lr after {E * M} of {l_card.lr_decay_steps} steps {l_card.optimizer.param_groups[0]['lr']:.3g}"
        if "losses/cpca" in m_card:
            extra += f", cpca {m_card['losses/cpca']:.5f}"
        text.append(f"{name}: losses max rel {max(loss_err.values()):.3g}, parameters max {param_err:.3g}, least "
                    f"share {min(r[0] for r in rows.values()):.4f} over {len(rows)} tensors, beyond lr/10: "
                    f"{gap_trace(rows)}; a fault planted in action_head.weight's gradient fails the rule in {len(caught)} "
                    f"tensors ({caught[:3]}){extra}")
    log(f"[ppo-switches] {gpu}: one update (N={n_env}, T={T}, {E} x {M} Adam steps, float32) on the card against "
        f"the CPU (gates: losses {SWITCH_RTOL} relative, each tensor's share within lr/10 >= {UPDATE_TENSOR_SHARE}): "
        + "; ".join(text) + f"; the phase {time.perf_counter() - t_phase:.1f} s")


def to_device(x, dev):
    """A tensor, or a dict / list of them, copied to ``dev``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return type(x)(to_device(v, dev) for v in x)


def vln_env(dev, c, visual=True):
    """make_vln_env at ``c``'s sizes (seed 0, no pointgoal), with
    VLN["hw"]-square depth when ``visual``."""
    from habitat_torch.tasks.vln import make_vln_env

    specs = (("HabitatSimDepthSensor", {"height": VLN["hw"], "width": VLN["hw"]}),) if visual else ()
    return make_vln_env(num_envs=c["num_envs"], num_scenes=c["num_scenes"], episodes_per_scene=c["episodes_per_scene"],
                        seed=0, with_pointgoal=False, max_episode_steps=c["max_episode_steps"], visual_specs=specs,
                        device=dev)


def language_policy(env, dev, hidden, backbone="resnet9", dtype=None):
    """The policy for ``env``'s observations (instruction or question, state
    sensors, depth when observed), goal_keys=(), bf16 unless ``dtype``."""
    import torch

    from habitat_torch.models.policy import make_pointnav_resnet_policy, obs_inputs_of

    shapes = env.observation_shapes
    visual = "depth" in shapes
    kw = dict(visual_inputs=("depth",), input_hw=tuple(shapes["depth"][0][:2])) if visual else {}
    return make_pointnav_resnet_policy(env.num_actions, backbone=backbone, hidden_size=hidden, has_visual=visual,
                                       goal_keys=(), dtype=dtype or torch.bfloat16, device=dev,
                                       **obs_inputs_of(shapes), **kw)


def vln_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[vln]: VLN behavior cloning at scripts/train_vln_tpu.py's configuration
    (VLN) on the card: a warm-up and VLN_UPDATES timed updates (ms split into
    the rollout, env + teacher, and the update; env-steps/s; peak memory;
    idle share and launches of one profiled update). Gates: #1 launched 1 +
    T per update, #11 once per update, no plain version on a card tensor;
    #11 bit-equal to its plain version on the last update's stem-pool input;
    tests/test_eqa_vln.py::test_vln_seq2seq_il's rule (VLN_RULE) on the
    card; one float32 update of [vln]'s net without its encoder (VLN_CHECK)
    on the card against the CPU: teachers equal, loss within BC_LOSS_RTOL
    relative, parameters by [check]'s per-tensor share rule. Returns the path's launch counts
    and the #11 check."""
    import numpy as np
    import torch

    from habitat_torch.baselines.il.bc_trainer import BCConfig, BCLearner
    from habitat_torch.ops import pool

    t_phase = time.perf_counter()
    N, T, hw = VLN["num_envs"], VLN["num_steps"], VLN["hw"]
    zero_counts()
    for p in plain_watch:
        p.start()
    env = vln_env(dev, VLN)
    torch.manual_seed(0)
    policy = language_policy(env, dev, VLN["hidden"])
    lrn = BCLearner(env, policy, BCConfig(num_steps=T, lr=VLN["lr"]))
    split = {"rollout": [], "update": []}

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    lrn.collect_rollout = timed("rollout", lrn.collect_rollout)
    lrn.update = timed("update", lrn.update)
    updates = 1 + VLN_UPDATES
    pool_backward, last_bwd = pool._MaxPool3x3s2.backward, {}

    def backward_seen(ctx, dy):
        gx = pool_backward(ctx, dy)
        if pool.max_pool_3x3s2_bwd.launches == updates:
            x, y = ctx.saved_tensors
            last_bwd["args"] = (x, y, dy.contiguous(memory_format=torch.channels_last))
        return gx

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = lrn.init()
    walls = []
    with mock.patch.object(pool._MaxPool3x3s2, "backward", staticmethod(backward_seen)):
        for i in range(updates):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, metrics = lrn.train_step(st)
            metrics = {k: v.item() for k, v in metrics.items()}
            if i:
                walls.append(time.perf_counter() - t0)
            if not all(np.isfinite(v) for v in metrics.values()):
                fail(f"[vln] non-finite metrics {metrics}")
    torch.cuda.synchronize()
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[vln]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    peak = torch.cuda.max_memory_allocated()
    launches = path_counts("[vln] train path", raycast_fused_sel_t=1 + updates * T, max_pool_3x3s2_bwd=updates)
    del lrn.collect_rollout, lrn.update
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    roll, upd = split["rollout"][1:], split["update"][1:]
    rates = sorted(N * T / w for w in walls)
    (st, _), dev_ms, n_launch, top = device_time_and_launches(lambda: lrn.train_step(st))
    log(f"[vln] {gpu}: scripts/train_vln_tpu.py's VLN BC (N={N}, {VLN['num_scenes']} scenes x "
        f"{VLN['episodes_per_scene']} episodes, T={T}, {hw}x{hw} depth + instruction (64 tokens) + GPS + compass, "
        f"resnet9 + LSTM-{VLN['hidden']} bf16, lr {VLN['lr']}): ms per update "
        f"{[round(w * 1e3, 1) for w in walls]} (median {med(walls) * 1e3:.1f}) = rollout (env + teacher) "
        f"{[round(x, 1) for x in roll]} + update {[round(x, 1) for x in upd]} (warm-up {split['rollout'][0]:.1f} + "
        f"{split['update'][0]:.1f}); env-steps/s median {rates[len(rates) // 2]:.1f} (min {rates[0]:.1f}, max "
        f"{rates[-1]:.1f}); peak memory {peak / 2**30:.2f} GiB; one profiled update: device {dev_ms:.1f} ms, idle "
        f"share {1 - dev_ms / (med(walls) * 1e3):.3f} of the median update, {n_launch} launches; last metrics "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
        + f"; launches {launches} (#1 1 + {T} per update, #11 one per update), no plain version on a card tensor")
    for e in top[:4]:
        log(f"[vln]   {device_us(e) / 1e3:8.3f} ms {e.count:5d}x  {e.key[:80]}")
    x, y, dy = last_bwd.pop("args")
    mb_shape = (N * T, 32, hw // 2, hw // 2)
    if tuple(x.shape) != mb_shape or x.dtype != torch.bfloat16:
        fail(f"[vln] the pool backward got {tuple(x.shape)} {x.dtype}, want {mb_shape} bfloat16")
    _, pool_err = pool_check(f"[vln] update {mb_shape}", (x, y, dy))
    del x, y, dy, lrn, policy, st, env
    torch.cuda.empty_cache()

    # tests/test_eqa_vln.py::test_vln_seq2seq_il's rule on the card
    c = VLN_RULE
    torch.manual_seed(0)
    renv = vln_env(dev, c, visual=False)
    rlrn = BCLearner(renv, language_policy(renv, dev, c["hidden"], backbone="resnet18"),
                     BCConfig(num_steps=c["num_steps"], lr=c["lr"]))
    rst, losses = rlrn.init(), []
    t0 = time.perf_counter()
    for _ in range(c["updates"]):
        rst, m = rlrn.train_step(rst)
        losses.append(m["losses/bc_loss"].item())
    rule_s = time.perf_counter() - t0
    if not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
        fail(f"[vln] test_vln_seq2seq_il's rule: bc_loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # one float32 update of the blind net, card against CPU, from the same
    # weights and env state, the CPU's on the card's batch. Blind, as [bc]'s:
    # from a fresh Adam the step is sign(g) * lr, and the stem's near-zero
    # gradients part in sign between cuDNN's and the CPU's float32
    # convolutions (35 of 1,568 stem weights with the encoder)
    cpu = torch.device("cpu")
    c = VLN_CHECK
    torch.manual_seed(0)
    runs = []
    for d in (dev, cpu):
        e = vln_env(d, c, visual=False)
        pol = language_policy(e, d, VLN["hidden"], dtype=torch.float32)
        if not runs:
            start = {k: v.detach().cpu().clone() for k, v in pol.state_dict().items()}
        pol.load_state_dict(start)
        cl = BCLearner(e, pol, BCConfig(num_steps=c["num_steps"], lr=VLN["lr"]))
        runs.append((cl, pol, cl.collect_rollout(cl.init())[1]))
    (cl_g, pol_g, b_g), (cl_c, pol_c, b_c) = runs
    teach_equal = torch.equal(b_g["teacher"].cpu(), b_c["teacher"])
    with cudnn_deterministic(True):
        m_g, _ = cl_g.update(b_g)
    m_c, _ = cl_c.update(to_device(b_g, cpu))
    loss_err = abs(m_g["losses/bc_loss"].item() - m_c["losses/bc_loss"].item()) / max(
        1.0, abs(m_c["losses/bc_loss"].item()))
    rows, bad = share_gate(start, {k: v.cpu() for k, v in pol_g.state_dict().items()}, pol_c.state_dict(),
                           VLN["lr"])
    if not teach_equal or loss_err > BC_LOSS_RTOL or bad:
        fail(f"[vln] float32 update, card against CPU: teachers equal {teach_equal}, loss {loss_err:.3g} relative, "
             f"tensors below the share: {bad} ({gap_trace(rows)})")
    log(f"[vln] {gpu}: test_vln_seq2seq_il's rule (N={VLN_RULE['num_envs']}, blind resnet18 + LSTM-"
        f"{VLN_RULE['hidden']}, T={VLN_RULE['num_steps']}, {VLN_RULE['updates']} updates): bc_loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} in {rule_s:.1f} s; #11 on the last update's own input bit-equal to its plain version; "
        f"float32 update ([vln]'s net, blind, N={c['num_envs']}, T={c['num_steps']}) card against CPU on the card's batch: "
        f"teachers equal at all {b_c['teacher'].numel()} (each device's own rollout), loss {loss_err:.3g} relative, "
        f"least share {min(r[0] for r in rows.values()):.4f}, beyond lr/10: {gap_trace(rows)}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, dict(shape=list(mb_shape), max_abs_err=pool_err)


def eqa_visual_env(dev, n=4, size=32):
    """tests/test_eqa_il.py's env: 2 procedural scenes x 4 episodes (extent
    6), ``size``-square RGB, depth and semantics, pointgoal."""
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav

    scenes, episodes, fields = make_procedural_pointnav(num_scenes=2, episodes_per_scene=4, seed=0, extent=6.0)
    frame = {"height": size, "width": size}
    return make_nav_env(scenes, episodes, num_envs=n, precomputed_fields=fields, max_episode_steps=50, device=dev,
                        sensor_specs=(("HabitatSimRGBSensor", frame), ("HabitatSimDepthSensor", frame),
                                      ("HabitatSimSemanticSensor", frame), ("PointGoalWithGPSCompassSensor", None)))


def eqa_il_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[eqa-il]: the three EQA imitation trainers through trainer_from_config
    on ppo_pointnav_example.yaml at num_environments=EQA_IL["num_envs"]:
    a warm-up and EQA_IL["updates"] timed updates each (PACMAN: one
    collect_expert first), ms per update and #1's launches, exact: the
    CNN pretrain 1 (reset) + 1 per update, VQA 1 (goal table) + 1 (reset)
    + 1 per update (the walk step, whose frame is the next update's),
    PACMAN 1 (goal table) + 1 (reset) + 1 per expert env step and none per
    update. Gates, each the rule of a JAX test, on the card:
    test_eqa_cnn_pretrain_learns, test_vqa_learner,
    test_pacman_bc_loss_decreases; for each trainer one float32 step card
    against CPU (the card's frames or batch on both; given walk actions):
    losses within BC_LOSS_RTOL relative, [check]'s per-tensor share rule.
    Returns {trainer: #1 launches}."""
    import dataclasses
    from types import SimpleNamespace

    import numpy as np
    import torch

    from habitat_torch.baselines.il.eqa_trainers import EQACNNPretrainLearner, VQALearner
    from habitat_torch.baselines.il.pacman import PacmanTrainer
    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct
    from habitat_torch.tasks.eqa import make_eqa_env

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    N, U = EQA_IL["num_envs"], EQA_IL["updates"]
    counts, texts = {}, []
    for name in EQA_IL_TRAINERS:
        cfg = get_config(CONFIG_EXPERIMENT + ".yaml", [f"habitat_baselines.trainer_name={name}",
                                                       f"habitat_baselines.num_environments={N}"])
        zero_counts()
        for p in plain_watch:
            p.start()
        t0 = time.perf_counter()
        torch.manual_seed(0)
        tr = construct.trainer_from_config(cfg, device=dev)
        lrn, env = tr.learner, tr.env
        extra, fixed = "", 1
        # the renders no update reads, and the JAX package's
        unread = "1, the reset's (JAX's init renders one for the model's shapes)"
        if name == "eqa-cnn-pretrain":
            box = [lrn.init(0)]

            def update():
                box[0], m = lrn.train_step(box[0])
                return m
        elif name == "vqa":
            fixed = 2
            unread = "1, the last walk step's (JAX renders each batch's frame inside its step and discards the walk's)"
            gen = torch.Generator(device=dev).manual_seed(2)
            box = list(env.reset_fn())

            def update():
                m = lrn.train_step(*box)
                with torch.no_grad():
                    box[:] = env.step_fn(box[0], torch.randint(0, 3, (N,), generator=gen, device=dev))[:2]
                return m
        else:
            t1 = time.perf_counter()
            batch = lrn.collect_expert(0)
            sync(dev)
            steps = int(batch[3].any(0).sum())
            fixed = 2 + steps
            unread = (f"all {fixed}: the features read the pointgoal, the frames nobody (JAX's collect_expert "
                      f"renders them too)")
            extra = (f"; collect_expert {time.perf_counter() - t1:.2f} s for {steps} env steps "
                     f"({(time.perf_counter() - t1) * 1e3 / steps:.1f} ms each, a host copy per step)")
            prepared = lrn.prepare_batch(batch)
            lrn.init_fn(0, batch)

            def update():
                return lrn.train_step(prepared)
        sync(dev)
        build_s = time.perf_counter() - t0
        ms = []
        for i in range(1 + U):
            sync(dev)
            t0 = time.perf_counter()
            m = {k: v.item() for k, v in update().items()}
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(v) for v in m.values()):
                fail(f"[eqa-il] {name}: non-finite metrics {m}")
        for p in plain_watch:
            p.stop()
        if plain_on_card:
            fail(f"[eqa-il] {name}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        per_update = 0 if name == "pacman" else 1
        got = path_counts(f"[eqa-il] {name}", raycast_fused_sel_t=fixed + per_update * (1 + U))
        counts[name] = got["raycast_fused_sel_t"]
        texts.append(f"{name}: set-up {build_s:.2f} s{extra}; ms per update {[round(x, 2) for x in ms[1:]]} (warm-up "
                     f"{ms[0]:.1f}); #1 {got['raycast_fused_sel_t']} = {fixed} + {per_update} per update, renders read "
                     f"by no update: {unread}; last "
                     + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
        del tr, lrn, env, update
    log(f"[eqa-il] {gpu}: trainer_from_config({CONFIG_EXPERIMENT}.yaml, num_environments={N}), 64x64 frames, "
        f"{1 + U} updates each: " + "; ".join(texts) + "; no plain version on a card tensor")
    torch.cuda.empty_cache()

    # the JAX tests' rules on the card
    rules = {}
    torch.manual_seed(0)
    env = eqa_visual_env(dev)
    cl = EQACNNPretrainLearner(env, num_classes=16)
    st = cl.init(0)
    st, m0 = cl.train_step(st)
    for _ in range(10):
        st, m = cl.train_step(st)
    rules["cnn"] = (m0["losses/total"].item(), m["losses/total"].item())
    if not (np.isfinite(rules["cnn"][1]) and rules["cnn"][1] < rules["cnn"][0] and st.update_idx == 11):
        fail(f"[eqa-il] test_eqa_cnn_pretrain_learns' rule: total {rules['cnn']}, {st.update_idx} updates")
    E = env.table.num_episodes
    rng = np.random.default_rng(0)
    env.table = dataclasses.replace(
        env.table, goal_image=torch.as_tensor(rng.integers(0, 255, (E, 32, 32, 3), dtype=np.uint8), device=dev),
        extras={**env.table.extras,
                "question_tokens": torch.as_tensor(rng.integers(1, 50, (E, 6)).astype(np.int32), device=dev),
                "answer_token": torch.as_tensor(rng.integers(0, 8, (E,)).astype(np.int32), device=dev)})
    vl = VQALearner(env, vocab_size=64, num_answers=8)
    es, _ = env.reset_fn()
    vm = [vl.train_step(es)["losses/vqa"].item() for _ in range(16)]
    rules["vqa"] = (vm[0], vm[-1])
    if not (np.isfinite(vm[-1]) and vm[-1] < vm[0]):
        fail(f"[eqa-il] test_vqa_learner's rule: loss {vm[0]:.4f} -> {vm[-1]:.4f}")
    penv = make_eqa_env(num_envs=8, num_scenes=1, episodes_per_scene=4, seed=0, max_episode_steps=40, device=dev)
    pt = PacmanTrainer(penv, max_T=24)
    pbatch = pt.collect_expert(0)
    pprep = pt.prepare_batch(pbatch)
    pt.init_fn(0, pbatch)
    pl = [pt.train_step(pprep)["loss"].item() for _ in range(12)]
    rules["pacman"] = (pl[0], pl[-1])
    if not (np.isfinite(pl).all() and pl[-1] < 0.85 * pl[0]):
        fail(f"[eqa-il] test_pacman_bc_loss_decreases' rule: loss {pl[0]:.4f} -> {pl[-1]:.4f}")

    # one float32 step of each, card against CPU, on the card's inputs
    checks = {}

    def held(name, lrn_g, lrn_c, step_g, step_c, lr):
        start = {k: v.detach().cpu().clone() for k, v in lrn_g.model.state_dict().items()}
        lrn_c.model.load_state_dict(start)
        with cudnn_deterministic(True):
            m_g = {k: v.item() for k, v in step_g().items()}
        m_c = {k: v.item() for k, v in step_c().items()}
        err = max(abs(m_g[k] - m_c[k]) / max(1.0, abs(m_c[k])) for k in m_c)
        rows, bad = share_gate(start, {k: v.cpu() for k, v in lrn_g.model.state_dict().items()},
                               lrn_c.model.state_dict(), lr)
        if err > BC_LOSS_RTOL or bad:
            fail(f"[eqa-il] {name} float32 step, card against CPU: losses {err:.3g} relative, tensors below the "
                 f"share: {bad} ({gap_trace(rows)})")
        checks[name] = f"{name} losses {err:.3g} relative, least share {min(r[0] for r in rows.values()):.4f}"

    torch.manual_seed(1)
    cg = EQACNNPretrainLearner(env, num_classes=16)
    cc = EQACNNPretrainLearner(SimpleNamespace(device=cpu), num_classes=16)
    walk = torch.as_tensor(np.random.default_rng(1).integers(1, 4, env.num_envs), device=dev)
    frames = cg.frames(env.step_fn(env.reset_fn()[0], walk)[1])
    held("eqa-cnn-pretrain", cg, cc, lambda: cg.update(*frames), lambda: cc.update(*to_device(frames, cpu)), 1e-3)
    vg = VQALearner(env, vocab_size=64, num_answers=8)
    vc = VQALearner(SimpleNamespace(device=cpu, observation_shapes=env.observation_shapes,
                                    table=env.table.to(cpu)), vocab_size=64, num_answers=8)
    obs = env._observations(es)
    held("vqa", vg, vc, lambda: vg.train_step(es, obs),
         lambda: vc.train_step(state_to(es, cpu), to_device({"rgb": obs["rgb"]}, cpu)), 3e-4)
    pc = PacmanTrainer(SimpleNamespace(device=cpu), max_T=24)
    pc.init_fn(1, pbatch)
    pt.init_fn(1, pbatch)
    held("pacman", pt, pc, lambda: pt.train_step(pprep), lambda: pc.train_step(pc.prepare_batch(pbatch)), 1e-3)
    log(f"[eqa-il] {gpu}: the JAX tests' rules on the card: test_eqa_cnn_pretrain_learns total "
        f"{rules['cnn'][0]:.4f} -> {rules['cnn'][1]:.4f} (11 steps), test_vqa_learner {rules['vqa'][0]:.4f} -> "
        f"{rules['vqa'][1]:.4f} (16 steps), test_pacman_bc_loss_decreases {rules['pacman'][0]:.4f} -> "
        f"{rules['pacman'][1]:.4f} (12 steps, gate < 0.85 x the first); float32 step card against CPU: "
        + "; ".join(checks.values()) + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def eqa_referent_phase(gpu, dev, zero_counts, path_counts):
    """[eqa-referent]: PPO on the referent-EQA env at
    scripts/train_eqa_referent_tpu.py's widths (N=256, blind resnet9 +
    LSTM-96 over question + object table, T=12, 2 x 2 minibatch steps, lr
    1e-3; the table cut to EQA_REF's 4 x 256 episodes): a warm-up and
    EQA_REF_UPDATES timed train steps (env-steps/s, launches per env step,
    idle share); no kernel launched. Gate: one float32 update (1 epoch, 1
    minibatch) from the rollout's start, card against CPU: losses within
    LOSS_RTOL of max(1, |x|), [check]'s per-tensor share rule."""
    from types import SimpleNamespace

    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner, RolloutBatch
    from habitat_torch.tasks.eqa import make_referent_eqa_env

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    N, T = EQA_REF["num_envs"], EQA_REF_PPO["num_steps"]
    zero_counts()
    t0 = time.perf_counter()
    env = make_referent_eqa_env(seed=0, device=dev, **EQA_REF)
    setup_s = time.perf_counter() - t0
    torch.manual_seed(0)
    policy = language_policy(env, dev, 96)
    lrn = PPOLearner(env, policy, PPOConfig(**EQA_REF_PPO), measure_keys=("answer_accuracy",))
    rs, walls, roll, upd, metrics = recipe_run("[eqa-referent]", lrn, 1 + EQA_REF_UPDATES, dev)
    sync(dev)
    path_counts("[eqa-referent]")  # blind: no kernel, as in the JAX recipe
    rs, batch, lv, h0, _ = lrn.collect_rollout(rs)
    start = {k: v.detach().cpu().clone() for k, v in policy.state_dict().items()}
    check = PPOConfig(**{**EQA_REF_PPO, "ppo_epoch": 1, "num_mini_batch": 1})

    def one_update(device):
        pol = language_policy(env, device, 96, dtype=torch.float32)
        pol.load_state_dict(start)
        lr_ = PPOLearner(SimpleNamespace(num_envs=N, device=device), pol, check)
        b = RolloutBatch(**{k: to_device(v, device) for k, v in batch._asdict().items()})
        m = lr_.update(torch.Generator(device=device).manual_seed(0), b, lv.to(device), h0.to(device))
        return {k: v.item() for k, v in m.items()}, {k: v.detach().cpu() for k, v in pol.state_dict().items()}

    m_card, p_card = one_update(dev)
    m_cpu, p_cpu = one_update(cpu)
    loss_err = max(abs(m_card[k] - m_cpu[k]) / max(1.0, abs(m_cpu[k])) for k in m_cpu)
    rows, bad = share_gate(start, p_card, p_cpu, EQA_REF_PPO["lr"])
    if loss_err > LOSS_RTOL or bad:
        fail(f"[eqa-referent] float32 update, card against CPU: losses {loss_err:.3g} relative, tensors below the "
             f"share: {bad} ({gap_trace(rows)})")
    act = torch.zeros(N, dtype=torch.int64, device=dev)
    log(f"[eqa-referent] {gpu}: scripts/train_eqa_referent_tpu.py's widths (N={N}, {EQA_REF['num_scenes']} scenes x "
        f"{EQA_REF['episodes_per_scene']} episodes, cut from x 4096; episodes of {EQA_REF['max_episode_steps']} steps; "
        f"blind resnet9 + LSTM-96 over question + eqa_objects; PPO T={T}, 2 x 2 minibatch steps; env set-up "
        f"{setup_s:.1f} s): " + recipe_text(N, T, walls, roll, upd, metrics)
        + f"; answer_accuracy {metrics['m_answer_accuracy'] / max(metrics['done_count'], 1.0):.4f} over the last "
        f"rollout's {metrics['done_count']:.0f} episodes; no kernel launched; "
        f"float32 update (1 epoch, 1 minibatch) card against CPU: losses {loss_err:.3g} relative, least share "
        f"{min(r[0] for r in rows.values()):.4f}, beyond lr/10: {gap_trace(rows)}; "
        + idle_text(dev, env, rs.env_state, act) + f"; the phase {time.perf_counter() - t_phase:.1f} s")


def agents_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[agents]: PPOAgent (deterministic) from the flagship export drives one
    flagship env (N=1: its scenes, 128x128 depth + pointgoal, 200 steps) for
    one episode, one observation at a time: ms per act, success and SPL.
    Gates: at every step the agent's action equals the greedy action of the
    same policy's batched forward on the same observation, carry and mask
    (and the carries stay equal); #1 once per render; no plain version on a
    card tensor. GoalFollower then drives the flagship env for one episode
    (logged), and the open room AGENT_ROOM for one, where it must reach the
    goal. Returns #1's launches."""
    import torch

    from habitat_torch.baselines.agents.ppo_agents import PPOAgent
    from habitat_torch.baselines.agents.simple_agents import GoalFollower
    from habitat_torch.baselines.flagship import PROTOCOL, WEIGHTS
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.convert import load_policy_file

    t_phase = time.perf_counter()
    p = PROTOCOL
    flagship = make_procedural_pointnav(num_scenes=p["num_scenes"], episodes_per_scene=p["episodes_per_scene"],
                                        seed=p["scene_seed"])

    def nav_env(data, res=p["res"]):
        scenes, episodes, fields = data
        sensors = ((("HabitatSimDepthSensor", {"height": res, "width": res}),) if res else ()) + (
            ("PointGoalWithGPSCompassSensor", None),)
        return make_nav_env(scenes, episodes, num_envs=1, precomputed_fields=fields,
                            max_episode_steps=p["max_episode_steps"], sensor_specs=sensors, device=dev)

    def episode(env, agent, check=None):
        st, obs = env.reset_fn()
        agent.reset()
        steps, act_ms = 0, []
        while True:
            sync(dev)
            t0 = time.perf_counter()
            a = agent.act({k: v[0] for k, v in obs.items()})
            act_ms.append((time.perf_counter() - t0) * 1e3)
            if check:
                check(obs, a)
            st, obs, _, done, info = env.step_fn(st, torch.tensor([a], device=dev))
            steps += 1
            if done[0]:
                return steps, act_ms, {k: v[0].item() for k, v in info.items()}

    env = nav_env(flagship)
    policy = load_policy_file(WEIGHTS, device=dev)
    agent = PPOAgent(policy, deterministic=True)
    carry = dict(h=policy.initial_hidden(1), prev=torch.zeros(1, dtype=torch.int32, device=dev),
                 mask=torch.zeros(1, device=dev))
    bad = []

    @torch.no_grad()
    def batched(obs, a):
        logits, _, carry["h"] = policy(obs, carry["h"], carry["prev"], carry["mask"])
        b = int(logits.argmax(-1)[0])
        if b != a or not torch.equal(carry["h"], agent.hidden):
            bad.append((len(bad), a, b))
        carry["prev"] = torch.tensor([b], dtype=torch.int32, device=dev)
        carry["mask"] = torch.ones(1, device=dev)

    zero_counts()
    for q in plain_watch:
        q.start()
    steps, act_ms, info = episode(env, agent, batched)
    sync(dev)
    for q in plain_watch:
        q.stop()
    if plain_on_card:
        fail(f"[agents]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    launches = path_counts("[agents] PPOAgent episode", raycast_fused_sel_t=1 + steps)
    if bad:
        fail(f"[agents] PPOAgent parts from the batched greedy policy at {len(bad)} of {steps} steps: {bad[:4]}")
    act_ms = sorted(act_ms[1:])
    g_steps, _, g_info = episode(nav_env(flagship, res=None), GoalFollower())
    r_steps, _, r_info = episode(nav_env(make_procedural_pointnav(**AGENT_ROOM), res=None), GoalFollower())
    if r_info["success"] != 1.0:
        fail(f"[agents] GoalFollower in the open room: {r_info}")
    s_steps, s_ruled, s_parted, s_gap, s_ms = sampled_agent_check(dev, nav_env(flagship))
    log(f"[agents] {gpu}: PPOAgent (flagship export, resnet18 + LSTM-512, 128x128 depth + pointgoal, "
        f"deterministic) on one flagship env: {steps} steps, success {info['success']:.0f}, SPL {info['spl']:.4f}; "
        f"ms per act median {act_ms[len(act_ms) // 2]:.2f} (min {act_ms[0]:.2f}, max {act_ms[-1]:.2f}); the action "
        f"and carry equal to the batched greedy policy's at every step; #1 {launches['raycast_fused_sel_t']} = 1 + "
        f"{steps}; GoalFollower: the flagship env's first episode {g_steps} steps, success {g_info['success']:.0f}, "
        f"collisions {g_info['collisions']:.0f} (its goal lies behind walls), the open room's {r_steps} steps, "
        f"success {r_info['success']:.0f}, SPL {r_info['spl']:.4f}; sampling PPOAgent (seed 0, JAX's draws: the "
        f"key split at every act, categorical = argmax of Gumbel noise + logits) on the card beside the same agent "
        f"on the CPU for {s_steps} acts of the flagship env: the noise bit-equal card against CPU at every act, "
        f"card-vs-CPU logit gap <= {s_gap:.3g}, the actions equal at all {s_ruled} acts whose top-two noisy logits "
        f"lie more than twice that apart, parted at acts {s_parted}; card ms per act {ms_text(s_ms[1:])}; "
        f"the phase {time.perf_counter() - t_phase:.1f} s")
    return launches["raycast_fused_sel_t"]


def timed_calls(fn, ms):
    """fn, appending each call's wall ms to ``ms`` (the card synchronised
    after it; Env.step and PPOAgent.act already wait for a host copy)."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        ms.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def ms_text(ms):
    ms = sorted(ms)
    return f"median {ms[len(ms) // 2]:.2f} (min {ms[0]:.2f}, max {ms[-1]:.2f})"


def env_api_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=ENV_API):
    """[env-api]: the single-env API at the flagship's width. (a)
    Benchmark(pointnav_procgen.yaml).local_evaluate(PPOAgent(flagship
    export, deterministic)) over size["bench_episodes"] episodes (128x128
    depth + pointgoal): success, SPL, ms per Env.step and per act, #1 once
    per render, then 3 profiled Env.steps (device ms, idle share, launches).
    (b) Env on the mini on-disk dataset with TopDownMap, RuntimePerfStats and
    GfxReplayMeasure, the same agent for all its episodes, a
    BatchedEnv(N=1, auto_reset_done=False) stepped beside it from
    reset_to_fn with the same actions. Gates: observations equal, metrics,
    reward and done equal at every reset and step; the fog never shrinks;
    each episode's replay parses with steps + 1 keyframes; #1 launched
    exactly once per render of either env and per Env.render(); no plain
    version on a card tensor; #1 on one step's inputs and on Env.render()'s
    256x256 frame (a blind Env on the same dataset) against its plain
    version at the [kernel] gates. (c) The velocity path at N=size["vel_envs"]
    on the bench scenes (128x128 depth, size["vel_steps"] steps of fixed
    commands, size["vel_stops"] envs auto-stopped at step 20): each step
    against the same env's state sensors on the CPU from the card's state
    (positions within VEL_POS_ATOL, dones equal), ms per step, #1 once per
    render. Returns #1's launches in (a) + (b) + (c)."""
    import json

    import numpy as np
    import torch

    from habitat_torch.baselines.agents.ppo_agents import PPOAgent
    from habitat_torch.baselines.flagship import WEIGHTS
    from habitat_torch.config.default import get_config
    from habitat_torch.config.omega import Config, read_write
    from habitat_torch.core.batched_env import BatchedEnv
    from habitat_torch.core.benchmark import Benchmark
    from habitat_torch.core.env import Env
    from habitat_torch.models.convert import load_policy_file
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    agent = PPOAgent(load_policy_file(WEIGHTS, device=dev), deterministic=True)

    def watched(tag, fn):
        for p in plain_watch:
            p.start()
        try:
            return fn()
        finally:
            sync(dev)
            for p in plain_watch:
                p.stop()
            if plain_on_card:
                fail(f"[env-api] {tag}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")

    def kernel_check(tag, env, st, h, w):
        """#1 on the render inputs of ``st`` at h x w against its plain
        version (launches made here are not the path's)."""
        ctx = env._make_ctx(st)
        kernel, args, kwargs, _ = rc.closest_hit_call(env.pack, ctx.sid, st.pos + torch.tensor(
            [0.0, 1.25, 0.0], device=dev), st.yaw, st.pitch, height=h, width=w)
        if kernel is not rk.raycast_fused_sel_t:
            fail(f"[env-api] {tag} should take the frustum-selected kernel")
        return agreement(f"[env-api] {tag}", kernel(*args, **kwargs), kernel.plain(*args, **kwargs))

    # (a) Benchmark.local_evaluate with the flagship agent
    zero_counts()
    bench = Benchmark(ENV_API_CONFIG, device=dev)
    env = bench._env
    step_ms, act_ms, resets = [], [], []
    env.step, agent.act = timed_calls(env.step, step_ms), timed_calls(agent.act, act_ms)
    env.reset = timed_calls(env.reset, resets)
    bm = watched("Benchmark", lambda: bench.local_evaluate(agent, num_episodes=size["bench_episodes"]))
    bench_launches = path_counts("[env-api] Benchmark", raycast_fused_sel_t=len(resets) + len(step_ms))
    if not (len(resets) == size["bench_episodes"] and 0.0 <= bm["success"] <= 1.0 and np.isfinite(bm["spl"])):
        fail(f"[env-api] Benchmark: {len(resets)} resets, metrics {bm}")
    del env.step, env.reset, agent.act  # the classes' methods again
    env.reset()
    _, dev_ms, n_launch, _ = device_time_and_launches(lambda: [env.step(1) for _ in range(3)])
    prof_ms = sorted(step_ms)[len(step_ms) // 2]
    log(f"[env-api] {gpu}: Benchmark({ENV_API_CONFIG}).local_evaluate(PPOAgent(flagship export, deterministic)), "
        f"{size['bench_episodes']} episodes ({env.number_of_episodes} in the dataset, 128x128 depth + pointgoal): "
        f"success {bm['success']:.4f}, SPL {bm['spl']:.4f}, distance to goal {bm['distance_to_goal']:.3f}; "
        f"{len(step_ms)} Env.steps, ms per Env.step {ms_text(step_ms)}, ms per act {ms_text(act_ms)}; "
        f"#1 {bench_launches['raycast_fused_sel_t']} = {len(resets)} resets + {len(step_ms)} steps, no plain version "
        f"on a card tensor; 3 profiled Env.steps: device {dev_ms / 3:.3f} ms per step (idle share "
        f"{1 - dev_ms / (3 * prof_ms):.3f} against the median step), {n_launch / 3:.0f} launches per Env.step")

    # (b) Env on the mini on-disk dataset with the host measures, a batched
    # env beside it
    overrides = [o.format(root=ROOT) for o in MINI_DATASET] + [
        f"habitat.environment.max_episode_steps={size['mini_max_steps']}"]
    cfg = get_config(ENV_API_CONFIG, overrides)
    with read_write(cfg) as c:
        for name, kind in (("top_down_map", "TopDownMap"), ("runtime_perf_stats", "RuntimePerfStats"),
                           ("gfx_replay", "GfxReplayMeasure")):
            c.habitat.task.measurements[name] = Config({"type": kind})
    zero_counts()
    env = Env(cfg, device=dev)
    inner = env.sim
    beside = BatchedEnv(inner.pack, inner.table, np.zeros((1, 1), np.int32), inner.sensors, inner.measures,
                        inner.actions, device=dev, max_episode_steps=inner.max_episode_steps,
                        reward_spec=inner.reward_spec, slide_substeps=inner.slide_substeps, auto_reset_done=False)
    device_keys = {m.uuid for m in inner.measures} | {"is_collision"}

    def same(tag, obs, bobs, values, reward_done=None, bstep=None):
        for k in bobs:
            if not torch.equal(obs[k], bobs[k][0]):
                fail(f"[env-api] {tag}: {k} differs from the batched env's by "
                     f"{(obs[k].double() - bobs[k][0].double()).abs().max().item()}")
        m = env.get_metrics()
        got = {k: float(m[k]) for k in m if k in device_keys}
        want = {k: v[0].item() for k, v in values.items()}
        if got != want:
            fail(f"[env-api] {tag}: metrics {got} against the batched env's {want}")
        if bstep is not None:
            br, bd, bst = bstep
            if reward_done != (br[0].item(), bool(bd[0])) or env.episode_over != bool(bst.episode_over[0]):
                fail(f"[env-api] {tag}: reward, done {reward_done}, over {env.episode_over} against {br}, {bd}")

    mini = dict(steps=0, episodes=[], ms=[], acts=[], check=None)

    def mini_run():
        for e in range(size["mini_episodes"]):
            obs = env.reset()
            agent.reset()
            idx = env._ep_index[env.current_episode.episode_id]
            bs, bobs = beside.reset_to_fn(torch.tensor([idx], device=dev))
            same(f"episode {e} reset", obs, bobs, beside.measure_values(bs))
            fog, n = env.get_metrics()["top_down_map"]["fog_of_war_mask"], 0
            while not env.episode_over:
                a = agent.act(obs)
                t0 = time.perf_counter()
                obs = env.step(a)
                mini["ms"].append((time.perf_counter() - t0) * 1e3)
                bs, bobs, br, bd, binfo = beside.step_fn(bs, torch.tensor([a], device=dev))
                n += 1
                same(f"episode {e} step {n}", obs, bobs, binfo, env._last_reward_done, (br, bd, bs))
                m = env.get_metrics()
                if (m["top_down_map"]["fog_of_war_mask"] < fog).any():
                    fail(f"[env-api] episode {e} step {n}: the fog of war came back")
                fog = m["top_down_map"]["fog_of_war_mask"]
                if mini["check"] is None:
                    mini["check"] = env._state  # a step's state (steps make new states)
                if not env.episode_over and m["gfx_replay_keyframes_string"] != "":
                    fail(f"[env-api] episode {e} step {n}: a replay string before the episode's end")
            replay = json.loads(m["gfx_replay_keyframes_string"])["keyframes"]
            if len(replay) != n + 1:
                fail(f"[env-api] episode {e}: {len(replay)} keyframes after {n} steps")
            mini["steps"] += n
            mini["episodes"].append((env.current_episode.episode_id, n, float(m["success"]), float(m["spl"]),
                                     float(m["habitat_perf"]["step_ms"])))
        frame = env.render()
        if frame.shape != (inner._render_groups[0]["h"], inner._render_groups[0]["w"], 3):
            fail(f"[env-api] Env.render() of the depth config: {frame.shape}")

    watched("mini Env", mini_run)
    renders = 2 * (size["mini_episodes"] + mini["steps"]) + 1
    mini_launches = path_counts("[env-api] mini Env", raycast_fused_sel_t=renders)
    step_agree = kernel_check("one step's 128x128 frame", inner, mini["check"], 128, 128)
    ids = [x[0] for x in mini["episodes"]]
    if sorted(ids) != [str(i) for i in range(size["mini_episodes"])]:
        fail(f"[env-api] the mini Env played episodes {ids}")
    # Env.render()'s debug frame: a blind Env on the same dataset
    blind = get_config(ENV_API_CONFIG, overrides)
    with read_write(blind) as c:
        del c.habitat.simulator.agents.main_agent.sim_sensors["depth_sensor"]
    benv = Env(blind, device=dev)
    benv.reset()
    benv.step(2)
    zero_counts()
    frame = watched("Env.render()", benv.render)
    path_counts("[env-api] Env.render()", raycast_fused_sel_t=1)
    if frame.shape != (256, 256, 3) or frame.dtype != np.uint8:
        fail(f"[env-api] Env.render() without a visual sensor: {frame.shape} {frame.dtype}")
    render_agree = kernel_check("Env.render()'s 256x256 frame", benv.sim, benv._state, 256, 256)
    log(f"[env-api] {gpu}: Env on the mini on-disk dataset (PointNav-v1, 8 episodes, the 66-triangle glb stage, "
        f"85x85 navgrid; max_episode_steps {size['mini_max_steps']}) with TopDownMap, RuntimePerfStats and "
        f"GfxReplayMeasure, the flagship agent: {mini['steps']} steps over episodes (id, steps, success, SPL, "
        f"last step_ms) {[(i, n, s, round(spl, 4), round(ms, 2)) for i, n, s, spl, ms in mini['episodes']]}; ms per "
        f"Env.step {ms_text(mini['ms'])} with the host measures; observations, metrics, reward and done equal to a "
        f"BatchedEnv(N=1, auto_reset_done=False) beside it at every reset and step; the fog never shrank; every "
        f"replay parsed with steps + 1 keyframes; #1 {mini_launches['raycast_fused_sel_t']} = 2 x ("
        f"{size['mini_episodes']} resets + {mini['steps']} steps) + 1 Env.render(), no plain version on a card "
        f"tensor; #1 against its plain version on one step's frame: hit {step_agree[0]:.6f} idx {step_agree[1]:.6f} "
        f"|dt| {step_agree[2]:.3g}, on Env.render()'s 256x256 frame (blind Env, 1 launch): hit {render_agree[0]:.6f} "
        f"idx {render_agree[1]:.6f} |dt| {render_agree[2]:.3g}")

    # (c) the velocity path at N=vel_envs on the bench scenes, against the
    # same env's state sensors on the CPU
    n, steps = size["vel_envs"], size["vel_steps"]
    venv = bench_nav_env(dev, n, size["vel_hw"], action_names=("VelocityAction",))
    cpu_env = BatchedEnv(venv.pack, venv.table, venv.order.cpu().numpy(), venv.state_sensors, venv.measures,
                         venv.actions, device=cpu, max_episode_steps=venv.max_episode_steps,
                         reward_spec=venv.reward_spec, slide_substeps=venv.slide_substeps)
    t = torch.arange(steps, dtype=torch.float32)[:, None]
    i = torch.arange(n, dtype=torch.float32)[None, :]
    cmds = torch.stack([0.6 + 0.4 * torch.sin(0.3 * t + i), torch.sin(0.2 * t + 0.5 * i)], dim=-1)
    cmds[20, :size["vel_stops"]] = torch.tensor([-1.0, 0.0])  # under both minimums: auto-stop
    vel = dict(ms=[], worst=0.0, done=0, collided=0)

    def vel_run():
        st, _ = venv.reset_fn()
        for k in range(steps):
            st_c, _, _, done_c, _ = cpu_env.step_fn(state_to(st, cpu), cmds[k])
            sync(dev)
            t0 = time.perf_counter()
            st, obs, _, done, info = venv.step_fn(st, cmds[k].to(dev))
            sync(dev)
            vel["ms"].append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(done.cpu(), done_c):
                fail(f"[env-api] velocity step {k}: done card {done.tolist()}, CPU {done_c.tolist()}")
            err = (st.pos.cpu() - st_c.pos).abs().max().item()
            vel["worst"] = max(vel["worst"], err)
            if err > VEL_POS_ATOL:
                fail(f"[env-api] velocity step {k}: positions card - CPU {err}")
            vel["done"] += int(done_c.sum())
            vel["collided"] += int(info["is_collision"].sum().item())
        if obs["depth"].shape != (n, size["vel_hw"], size["vel_hw"], 1):
            fail(f"[env-api] velocity env depth {tuple(obs['depth'].shape)}")

    zero_counts()
    watched("velocity", vel_run)
    vel_launches = path_counts("[env-api] velocity", raycast_fused_sel_t=1 + steps)
    if vel["done"] < size["vel_stops"]:
        fail(f"[env-api] velocity: {vel['done']} episodes ended, the {size['vel_stops']} auto-stops among them")
    log(f"[env-api] {gpu}: the velocity path (VelocityAction, 4 rotate-then-translate sub-moves a step) at N={n} on "
        f"the bench scenes, {size['vel_hw']}x{size['vel_hw']} depth + RGB + pointgoal, {steps} steps of fixed "
        f"commands: ms per step {ms_text(vel['ms'])}; positions card - CPU (each step from the card's state) max "
        f"{vel['worst']:.3g} (gate {VEL_POS_ATOL}), dones equal ({vel['done']} episodes ended, {size['vel_stops']} by "
        f"auto-stop at step 20), {vel['collided']} colliding env-steps; #1 {vel_launches['raycast_fused_sel_t']} = 1 "
        f"+ {steps}; the phase {time.perf_counter() - t_phase:.1f} s")
    return sum(x["raycast_fused_sel_t"] for x in (bench_launches, mini_launches, vel_launches))


def outputs_agree(tag, out_g, out_c, skip=("robot_head_depth", "robot_head_rgb"), box_bound=None):
    """One step's outputs on the card against the CPU's from the same state:
    every state field, the observations the CPU env has (but ``skip``),
    reward, done and measures. Integer and boolean fields equal; floats
    within SOCIAL_ATOL + SOCIAL_ATOL * |cpu|. With ``box_bound`` (contacts)
    the box fields it names meet its bounds instead, and an env's
    observations, reward and measures get MOVED_SENSOR_FACTOR times its
    largest box-position gap on top. Returns (the largest float gap of the
    rest, the largest box-position gap)."""
    import dataclasses

    import torch

    (sg, og, rg, dg, ig), (sc, oc, rc_, dc, ic) = out_g, out_c
    n = dc.shape[0]
    box_gap = torch.zeros(n)
    if box_bound:
        box_gap = (sg.obj_pos.cpu() - sc.obj_pos).abs().reshape(n, -1).amax(-1)
    worst = 0.0
    for name, g, c, per_env in (
            [(f"state {f.name}", getattr(sg, f.name), getattr(sc, f.name), False) for f in dataclasses.fields(sc)]
            + [(f"obs {k}", og[k], oc[k], True) for k in oc if not k.endswith(skip)]
            + [("reward", rg, rc_, True), ("done", dg, dc, True)] + [(f"info {k}", ig[k], ic[k], True) for k in ic]):
        g = g.cpu()
        if not c.is_floating_point():
            if not torch.equal(g, c):
                fail(f"{tag} {name}: {int((g != c).sum())} elements differ from the CPU's")
            continue
        gap = (g - c).abs()
        field = name.split(" ")[-1]
        if box_bound and field in box_bound:
            atol, rtol = box_bound[field]
            tol = atol + rtol * c.abs()
        else:
            extra = MOVED_SENSOR_FACTOR * box_gap.reshape((n,) + (1,) * (c.dim() - 1)) if per_env else 0.0
            tol = SOCIAL_ATOL + SOCIAL_ATOL * c.abs() + extra
            worst = max(worst, gap.max().item() if gap.numel() else 0.0)
        if (gap > tol).any():
            fail(f"{tag} {name}: {int((gap > tol).sum())} elements beyond the bound, max |d| {gap.max().item():.3g}")
    return worst, box_gap.max().item()


def card_vs_cpu_steps(tag, env_g, env_c, actions, **kw):
    """The card env stepped through ``actions`` (CPU tensors, one per step)
    from its reset; each step also taken on the CPU env from the card's
    state, held by ``outputs_agree``. Returns (largest gap, largest box gap,
    dones)."""
    import torch

    st, _ = env_g.reset_fn()
    worst, box, dones = 0.0, 0.0, 0
    for t, a in enumerate(actions):
        out_g = env_g.step_fn(st, a.to(env_g.device))
        out_c = env_c.step_fn(st.to(torch.device("cpu")), a)
        w, b = outputs_agree(f"{tag} step {t}", out_g, out_c, **kw)
        worst, box, dones = max(worst, w), max(box, b), dones + int(out_c[3].sum())
        st = out_g[0]
    return worst, box, dones


def social_env_like(env, device, n=None, **kw):
    """A SocialNavBatchedEnv with ``env``'s pack, table and settings on
    ``device``: its first ``n`` envs (all by default); ``kw`` overrides."""
    from habitat_torch.tasks.rearrange.social_nav import SocialNavBatchedEnv

    args = dict(max_episode_steps=env.max_episode_steps, human_speed=env.human_speed, robot_step=env.fwd,
                two_agent=env.two_agent, with_visual=env.with_visual, render_size=env.render_size)
    order = env.order[:n] if n else env.order
    return SocialNavBatchedEnv(env.pack, env.table, order.cpu().numpy(), device=device, **{**args, **kw})


def social_policy(env, dev, i=None, visual=False, hidden=128, dtype=None):
    """scripts/train_social_tpu.py's policy: resnet9, hidden ``hidden``, no
    goal sensor, the env's (or agent i's) state sensors."""
    import torch

    from habitat_torch.models.policy import make_pointnav_resnet_policy, state_keys_of

    shapes = env.observation_shapes if i is None else env.agent_observation_shapes(i)
    return make_pointnav_resnet_policy(env.num_actions, has_visual=visual, hidden_size=hidden, goal_keys=(),
                                       backbone="resnet9", input_hw=env.render_size,
                                       state_keys=state_keys_of(shapes), dtype=dtype or torch.bfloat16, device=dev)


def social_actions(env, steps, seed):
    """``steps`` (N,) or (N, 2) action tensors: mostly forward, stop rarely."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (env.num_envs, 2) if env.two_agent else (env.num_envs,)
    return [torch.as_tensor(rng.choice(4, shape, p=[0.01, 0.59, 0.2, 0.2])) for _ in range(steps)]


def social_rules(dev):
    """tests/test_social_nav.py::test_social_nav_visual_humanoid_visible
    and ::test_seek_success_reachable_by_scripted_follow, and
    tests/test_two_agent.py::test_both_agents_params_update, on ``dev``.
    Returns their readings."""
    import dataclasses

    import numpy as np
    import torch

    from habitat_torch.baselines.multi_agent import TwoAgentPPOLearner
    from habitat_torch.baselines.ppo import PPOConfig
    from habitat_torch.tasks.rearrange.social_nav import make_social_nav_env

    env = make_social_nav_env(num_envs=2, with_visual=True, render_size=(32, 32), device=dev)
    st, obs = env.reset_fn()
    if obs["robot_head_rgb"].shape != (2, 32, 32, 3) or obs["robot_head_depth"].shape != (2, 32, 32, 1):
        fail(f"[social] visual observations {obs['robot_head_rgb'].shape} {obs['robot_head_depth'].shape}")
    fwd = torch.stack([-torch.sin(st.yaw), torch.zeros_like(st.yaw), -torch.cos(st.yaw)], -1)
    st = dataclasses.replace(st, human_pos=st.pos + fwd * 1.2)
    _, obs, *_ = env.step_fn(st, torch.ones(2, dtype=torch.int64, device=dev))
    img = obs["robot_head_rgb"].float()
    redness = (img[..., 0] > 1.5 * (img[..., 1] + 1)).float().mean().item()
    if not redness > 0.01:
        fail(f"[social] test_social_nav_visual_humanoid_visible's rule: redness {redness}")

    env = make_social_nav_env(num_envs=8, num_scenes=2, episodes_per_scene=8, seed=3, device=dev)
    st, obs = env.reset_fn()
    succ, stuck = np.zeros(8, bool), np.zeros(8, int)
    prev = st.pos.cpu().numpy()
    for t in range(300):
        rel = obs["humanoid_detector_sensor"].cpu().numpy()[:, 1:4]
        beta = np.arctan2(rel[:, 0], -rel[:, 2])
        dist = np.linalg.norm(rel[:, [0, 2]], axis=-1)
        turn = np.where(beta > 0, 3, 2)
        a = np.where(np.abs(beta) > 0.3, turn, np.where(dist > 1.4, 1, turn))
        a = np.where(stuck > 0, 3, a)
        stuck = np.maximum(stuck - 1, 0)
        st, obs, _, _, info = env.step_fn(st, torch.as_tensor(a, device=dev))
        pos = st.pos.cpu().numpy()
        stuck = np.where((a == 1) & (np.linalg.norm(pos - prev, axis=-1) < 1e-4), 5, stuck)
        prev = pos
        succ |= info["nav_seek_success"].cpu().numpy() > 0
        if succ.all():
            break
    if succ.mean() < 0.5:
        fail(f"[social] test_seek_success_reachable_by_scripted_follow's rule: {succ}")

    env = make_social_nav_env(num_envs=4, num_scenes=1, episodes_per_scene=4, seed=2, two_agent=True, device=dev)
    pols = [social_policy(env, dev, i, hidden=32) for i in range(2)]
    before = [[p.detach().clone() for p in pol.parameters()] for pol in pols]
    lrn = TwoAgentPPOLearner(env, pols, PPOConfig(num_steps=8, num_mini_batch=1, ppo_epoch=1))
    _, m = lrn.train_step(lrn.init(seed=0))
    losses = [m[f"losses/agent{i}_loss"].item() for i in range(2)]
    moved = [sum(not torch.equal(a, b) for a, b in zip(bef, pol.parameters())) for bef, pol in zip(before, pols)]
    if not (all(np.isfinite(losses)) and all(moved)):
        fail(f"[social] test_both_agents_params_update's rule: losses {losses}, tensors moved {moved}")
    return dict(redness=redness, follow=float(succ.mean()), follow_steps=t + 1, two_losses=losses, moved=moved)


def batch_to(batch, dev):
    """A RolloutBatch or TwoAgentBatch copied to ``dev``."""
    import dataclasses

    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{f.name: to_device(getattr(batch, f.name), dev)
                                             for f in dataclasses.fields(batch)})
    return type(batch)(*(to_device(v, dev) for v in batch))


def social_float32_checks(dev, env_a, env_c):
    """One float32 update of (a)'s learner and of (c)'s two agents on the
    card against the CPU, on the card's rollout (SOCIAL_CHECK_ENVS envs,
    the recipe's T) and the same minibatch permutations, from weights
    trained SOCIAL_START_UPDATES updates on the CPU (N=16, T=16). Returns
    the readings."""
    import torch

    from habitat_torch.baselines.multi_agent import TwoAgentPPOLearner
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner

    cpu, f32, out = torch.device("cpu"), torch.float32, {}
    start_cfg = dict(num_steps=16, num_mini_batch=2, ppo_epoch=2, lr=2.5e-4)
    # (a): start, the card's rollout and update, the CPU's update on it
    torch.manual_seed(0)
    pol0 = social_policy(env_a, cpu, dtype=f32)
    l0 = PPOLearner(social_env_like(env_a, cpu, 16), pol0, PPOConfig(**start_cfg), measure_keys=SOCIAL_MEASURES)
    rs0 = l0.init(seed=1)
    for _ in range(SOCIAL_START_UPDATES):
        rs0, _ = l0.train_step(rs0)
    start = {k: v.detach().clone() for k, v in pol0.state_dict().items()}
    cfg = PPOConfig(**SOCIAL_PPO["single"])
    perms = torch.stack([torch.randperm(SOCIAL_CHECK_ENVS, generator=torch.Generator().manual_seed(e))
                         for e in range(cfg.ppo_epoch)])
    res = {}
    for d in (dev, cpu):
        pol = social_policy(env_a, d, dtype=f32)
        pol.load_state_dict(start)
        lrn = PPOLearner(social_env_like(env_a, d, SOCIAL_CHECK_ENVS), pol, cfg, measure_keys=SOCIAL_MEASURES)
        if d == dev:
            rs = lrn.init(seed=0)
            rs, batch, last_v, h0, _ = lrn.collect_rollout(rs)
            args = (batch, last_v, h0, rs.log_alpha)
        with cudnn_deterministic(True):
            m = lrn.update(torch.Generator(device=d), *(batch_to(args[0], d),) + tuple(x.to(d) for x in args[1:]),
                           perms=perms.to(d))
        res[d.type] = ({k: v.item() for k, v in m.items()}, {k: v.detach().cpu() for k, v in pol.state_dict().items()})
    (m_g, p_g), (m_c, p_c) = res[dev.type], res["cpu"]
    loss_err = max(abs(m_g[k] - m_c[k]) / max(1.0, abs(m_c[k])) for k in m_c if k.startswith("losses/"))
    rows, bad = share_gate(start, p_g, p_c, cfg.lr)
    if loss_err > LOSS_RTOL or bad:
        fail(f"[social] (a) float32 update, card against CPU: losses {loss_err:.3g} relative, tensors below the "
             f"share: {bad} ({gap_trace(rows)})")
    out["single"] = dict(loss_err=loss_err, least_share=min(r[0] for r in rows.values()), gaps=gap_trace(rows))

    # (c): both agents
    torch.manual_seed(0)
    pols0 = [social_policy(env_c, cpu, i, dtype=f32) for i in range(2)]
    l0 = TwoAgentPPOLearner(social_env_like(env_c, cpu, 16), pols0, PPOConfig(**{**start_cfg, "num_mini_batch": 1}))
    ts0 = l0.init(seed=1)
    for _ in range(SOCIAL_START_UPDATES):
        ts0, _ = l0.train_step(ts0)
    starts = [{k: v.detach().clone() for k, v in p.state_dict().items()} for p in pols0]
    cfg = PPOConfig(**SOCIAL_PPO["two"])
    res = {}
    for d in (dev, cpu):
        pols = [social_policy(env_c, d, i, dtype=f32) for i in range(2)]
        for p, s in zip(pols, starts):
            p.load_state_dict(s)
        lrn = TwoAgentPPOLearner(social_env_like(env_c, d, SOCIAL_CHECK_ENVS), pols, cfg)
        if d == dev:
            _, batch, last_v, h0, _ = lrn.collect_rollout(lrn.init(seed=0))
        with cudnn_deterministic(True):
            m = lrn.update(batch_to(batch, d), [v.to(d) for v in last_v], [h.to(d) for h in h0])
        res[d.type] = ({k: v.item() for k, v in m.items()},
                       [{k: v.detach().cpu() for k, v in p.state_dict().items()} for p in pols])
    (m_g, p_g), (m_c, p_c) = res[dev.type], res["cpu"]
    for i in range(2):
        k = f"losses/agent{i}_loss"
        loss_err = abs(m_g[k] - m_c[k]) / max(1.0, abs(m_c[k]))
        rows, bad = share_gate(starts[i], p_g[i], p_c[i], cfg.lr)
        if loss_err > LOSS_RTOL or bad:
            fail(f"[social] (c) agent {i} float32 update, card against CPU: loss {loss_err:.3g} relative, tensors "
                 f"below the share: {bad} ({gap_trace(rows)})")
        out[f"agent{i}"] = dict(loss_err=loss_err, least_share=min(r[0] for r in rows.values()),
                                gaps=gap_trace(rows))
    return out


def social_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[social]: scripts/train_social_tpu.py's three modes on ``dev`` and
    their gates (the module docstring's 20). Returns (b)'s launch counts and
    the readings of #3's and #11's checks on its inputs."""
    import dataclasses

    import torch

    from habitat_torch.baselines.multi_agent import TwoAgentPPOLearner
    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.ops import pool
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk
    from habitat_torch.tasks.rearrange.social_nav import HUMANOID_SEM, make_social_nav_env

    t_phase = time.perf_counter()
    N, U = SOCIAL["num_envs"], 1 + SOCIAL_UPDATES
    cpu = torch.device("cpu")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731

    def watched(tag, fn):
        zero_counts()
        for p in plain_watch:
            p.start()
        try:
            out = fn()
        finally:
            for p in plain_watch:
                p.stop()
        if plain_on_card:
            fail(f"{tag}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        return out

    def report(tag, env, rs, act, walls, roll, upd, metrics, T, launches):
        rates = sorted(N * T / w for w in walls[1:])
        log(f"[social] {tag} {gpu}: " + recipe_text(N, T, walls, roll, upd, metrics)
            + f"; train env-steps/s median {med(rates):.1f} (min {rates[0]:.1f}, max {rates[-1]:.1f}) after the "
            f"warm-up; rollout {med(roll[1:]) / T:.2f} ms per env step with the policy; {idle_text(dev, env, rs, act)}; "
            f"episodes done {metrics.get('done_count', 0):.0f}; launches {launches}")

    # (a) single: blind resnet9
    env_a = make_social_nav_env(device=dev, **SOCIAL)
    log(f"[social] setup {time.perf_counter() - t_phase:.1f} s: {len(env_a.table.scene_idx)} episodes, pack "
        f"{tuple(env_a.pack.tri_mat.shape)}")
    torch.manual_seed(0)
    lrn = PPOLearner(env_a, social_policy(env_a, dev), PPOConfig(**SOCIAL_PPO["single"]), measure_keys=SOCIAL_MEASURES)
    rs, walls, roll, upd, metrics = watched("[social] (a)", lambda: recipe_run("[social] (a)", lrn, U, dev))
    fwd = torch.ones(N, dtype=torch.int64, device=dev)
    T = SOCIAL_PPO["single"]["num_steps"]
    report(f"(a) single, blind resnet9 + LSTM-128, T={T}", env_a, rs.env_state, fwd, walls, roll, upd, metrics, T,
           path_counts("[social] (a) train path"))
    for k in SOCIAL_MEASURES:
        if f"m_{k}" not in metrics:
            fail(f"[social] (a): the learner summed no {k}")

    # (b) vision: 64x64 head depth + RGB, the humanoid as the dynamic pass
    env_b = make_social_nav_env(device=dev, with_visual=True, render_size=SOCIAL_HW, **SOCIAL)
    h, w = SOCIAL_HW
    if rc.render_route(env_b.pack, h, w, "pinhole", dynamic=True) != "index":
        fail("[social] (b): the head camera should take the index route")
    c = SOCIAL_PPO["vision"]
    T = c["num_steps"]
    renders, pool_steps = 1 + U * T, U * c["ppo_epoch"] * c["num_mini_batch"]
    pool_backward, last_bwd = pool._MaxPool3x3s2.backward, {}

    def backward_seen(ctx, dy):
        gx = pool_backward(ctx, dy)
        if pool.max_pool_3x3s2_bwd.launches == pool_steps:
            x, y = ctx.saved_tensors
            last_bwd["args"] = (x, y, dy.contiguous(memory_format=torch.channels_last))
        return gx

    torch.manual_seed(0)
    lrn = PPOLearner(env_b, social_policy(env_b, dev, visual=True), PPOConfig(**c), measure_keys=SOCIAL_MEASURES)
    with mock.patch.object(pool._MaxPool3x3s2, "backward", staticmethod(backward_seen)):
        rs, walls, roll, upd, metrics = watched("[social] (b)", lambda: recipe_run("[social] (b)", lrn, U, dev))
    launches = path_counts("[social] (b) train path", raycast_index_t=2 * renders, max_pool_3x3s2_bwd=pool_steps)
    report(f"(b) vision, {h}x{w} depth + RGB, resnet9 + LSTM-128, T={T}", env_b, rs.env_state, fwd, walls, roll,
           upd, metrics, T, f"{launches} (#3 twice per render: 1 + {U} x {T} renders; #11 once per minibatch step)")
    x, y, dy = last_bwd.pop("args")
    mb_shape = (N * T // c["num_mini_batch"], 32, h // 2, w // 2)
    if tuple(x.shape) != mb_shape or x.dtype != torch.bfloat16:
        fail(f"[social] (b): the pool backward got {tuple(x.shape)} {x.dtype}, want {mb_shape} bfloat16")
    _, pool_err = pool_check(f"[social] (b) minibatch {mb_shape}", (x, y, dy))
    del x, y, dy, lrn
    # #3 on a frame with the humanoid 1.2 m ahead of every robot
    st = rs.env_state
    ahead = torch.stack([-torch.sin(st.yaw), torch.zeros_like(st.yaw), -torch.cos(st.yaw)], -1) * 1.2
    st = dataclasses.replace(st, human_pos=st.pos + ahead)
    index_calls = []

    def index_seen(*a, **k):
        index_calls.append((a, k))
        return rk.raycast_index_t(*a, **k)

    with mock.patch.object(rc, "raycast_index_t", index_seen):
        frames = env_b.render(st)
    if len(index_calls) != 2:
        fail(f"[social] (b): the head render made {len(index_calls)} raycast_index_t calls, want 2")
    index_check = {}
    for what, (a, k) in zip(("static", "dynamic"), index_calls):
        got, ref = rk.raycast_index_t(*a, **k), rk.raycast_index_t.plain(*a, **k)
        hit_a, idx_a, dt = agreement(f"[social] raycast_index_t on the humanoid frame's {what} pass", got, ref)
        index_check[what] = dict(matrix=list(a[0].shape), rays=a[2].numel() // 16, hit_agree=hit_a,
                                 idx_agree=idx_a, max_abs_err=dt)
    with mock.patch.object(rc, "raycast_index_t", rk.raycast_index_t.plain):
        frames_p = env_b.render(st)
    hit_f = share((frames["depth"] < 1.0) == (frames_p["depth"] < 1.0))
    sem_f = share(frames["semantic"] == frames_p["semantic"])
    seen = (frames["semantic"] == HUMANOID_SEM).reshape(N, -1).float().mean(-1)
    if not (hit_f >= PICK_FRAME_AGREE and sem_f >= PICK_FRAME_AGREE and (seen > 0).float().mean() >= 0.5):
        fail(f"[social] (b) humanoid frame: hit/miss {hit_f}, semantics {sem_f} equal to the plain version's; the "
             f"humanoid on pixels in {(seen > 0).float().mean().item()} of envs")
    del frames, frames_p, index_calls
    log(f"[social] (b) the path's own kernel inputs: max_pool_3x3s2_bwd on the last minibatch {mb_shape} bf16 "
        f"channels-last bit-equal to its plain version; raycast_index_t on the head render with the humanoid 1.2 m "
        f"ahead (N={N}, {h}x{w}) against its plain version: " + "; ".join(
            f"{what} {r['matrix']} x {r['rays']} rays hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} |dt| "
            f"{r['max_abs_err']:.3g}" for what, r in index_check.items())
        + f"; frames' hit/miss {hit_f:.6f} and semantics {sem_f:.6f} equal to the plain version's; the humanoid "
        f"covers {seen.mean().item():.4f} of the pixels, on {int((seen > 0).sum())} of {N} frames")
    del env_b
    torch.cuda.empty_cache()

    # (c) two: two blind resnet9 policies trained jointly
    env_c = make_social_nav_env(device=dev, two_agent=True, **SOCIAL)
    torch.manual_seed(0)
    lrn = TwoAgentPPOLearner(env_c, [social_policy(env_c, dev, i) for i in range(2)], PPOConfig(**SOCIAL_PPO["two"]))
    rs, walls, roll, upd, metrics = watched("[social] (c)", lambda: recipe_run("[social] (c)", lrn, U, dev))
    T = SOCIAL_PPO["two"]["num_steps"]
    report(f"(c) two agents, 2 x blind resnet9 + LSTM-128, T={T}", env_c, rs.env_state,
           torch.ones((N, 2), dtype=torch.int64, device=dev), walls, roll, upd, metrics, T,
           path_counts("[social] (c) train path"))

    # the card's env steps against the CPU's from the same state, (a) and (c)
    t0 = time.perf_counter()
    agree = {}
    for tag, env in (("(a)", env_a), ("(c)", env_c)):
        agree[tag] = card_vs_cpu_steps(f"[social] {tag}", env, social_env_like(env, cpu),
                                       social_actions(env, SOCIAL_CHECK_STEPS, seed=len(tag)))
    rules = watched("[social] rules", lambda: social_rules(dev))
    path_counts("[social] rules", raycast_index_t=4)  # the visible rule's reset and step, two passes each
    checks = social_float32_checks(dev, env_a, env_c)
    log(f"[social] {gpu}: card against CPU, {SOCIAL_CHECK_STEPS} steps at N={N} each from the card's state: "
        + "; ".join(f"{tag} largest gap {g:.3g} ({d} episodes ended)" for tag, (g, _, d) in agree.items())
        + f" (bound {SOCIAL_ATOL} + {SOCIAL_ATOL} relative; integer and boolean fields equal); the JAX tests' rules: "
        f"redness {rules['redness']:.4f} (> 0.01), scripted follow succeeded in {rules['follow']:.3f} of 8 envs in "
        f"{rules['follow_steps']} steps (>= 0.5), two-agent losses {[round(x, 4) for x in rules['two_losses']]} and "
        f"tensors moved {rules['moved']}; float32 updates card against CPU on the card's rollout (N="
        f"{SOCIAL_CHECK_ENVS}) from {SOCIAL_START_UPDATES} CPU updates: " + "; ".join(
            f"{k} loss {r['loss_err']:.3g} relative, least share {r['least_share']:.4f}, beyond lr/10: {r['gaps']}"
            for k, r in checks.items()) + f"; checks {time.perf_counter() - t0:.1f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, dict(index=index_check, pool=dict(shape=list(mb_shape), max_abs_err=pool_err))


def hab3_schedule(env, t, obj_pos):
    """Step t's flat actions (CPU) for the two-agent env: the robot drives,
    turns and moves its arm; the humanoid cycles through oracle navigation to
    entity 2, PDDL nav(object 1) / pick(1) / nav(goal 1) / place(goal 2), a
    pick target at object 2 and a joint action."""
    import torch

    offs, off = {}, 0
    for spec in env.action_specs:
        offs[spec.name] = off
        off += spec.dims(env)
    O, n, k = env.num_objects, env.num_envs, t % 12
    a = torch.zeros((n, off))
    b = offs["agent_0_base_velocity"]
    a[:, b], a[:, b + 1] = 0.6, 0.3
    a[:, offs["agent_0_arm_action"]] = 0.5
    op, oh = offs["agent_1_pddl_apply_action"], offs["agent_1_humanoid_pick_action"]
    if k < 4:
        a[:, offs["agent_1_oracle_nav_action"]] = 2.0
    elif k < 8:
        a[:, op:op + 3] = torch.tensor(([1, 0, 0], [0, 1, 0], [O + 1, 0, 0], [0, 0, O + 2])[k - 4], dtype=a.dtype)
    elif k == 8:
        a[:, oh:oh + 3] = obj_pos[:, 2].cpu() + torch.tensor([0.0, 0.1, 0.0])
    else:
        a[:, offs["agent_1_humanoidjoint_action"]:oh] = 0.25
    return a, offs


def hab3_rules(dev):
    """tests/test_task_actions.py::test_hab3_two_agent_declared_actions' and
    ::test_humanoid_joint_action_sets_root's assertions on ``dev``, as
    tests/test_torch_hab3.py applies them (N=2, one scene of 4 episodes;
    oracle navigation to entity 2; the root set 0.5 m away on a navigable
    point). Returns their readings."""
    import numpy as np
    import torch

    from habitat_torch.config.default import get_config
    from habitat_torch.core.construct import rearrange_env_from_config
    from habitat_torch.ops import navgrid as ng

    cfg = get_config("benchmark/rearrange/pick_procgen.yaml", list(HAB3_OVERRIDES + HAB3_RULE_SIZE))
    env = rearrange_env_from_config(cfg, num_envs=2, with_visual=False, device=dev)
    _, offs = hab3_schedule(env, 0, torch.zeros((2, 3, 3)))
    dims = env.action_dim
    st, obs = env.reset_fn()
    ok = [any(n.startswith("agent_1_") for n in env.action_names), "agent_0_joint" in obs,
          "agent_1_localization_sensor" in obs, "agent_0_other_agent_gps" in obs, "agent_1_other_agent_gps" in obs,
          set(obs) == set(env.observation_shapes)]
    hp0, rp0 = st.human_pos.clone(), st.pos.clone()
    a = torch.zeros((2, dims), device=dev)
    a[:, offs["agent_1_oracle_nav_action"]] = 2.0
    for _ in range(20):
        st, obs, _, _, info = env.step_fn(st, a)
    walked = torch.linalg.vector_norm(st.human_pos - hp0, dim=-1).min().item()
    ok += [walked > 0.3, torch.allclose(st.pos, rp0), "did_agents_collide" in info]
    op = offs["agent_1_pddl_apply_action"]
    for col in (op, op + 1):
        a = torch.zeros((2, dims), device=dev)
        a[:, col] = 1.0
        st, obs, *_ = env.step_fn(st, a)
    ok += [bool((st.human_held == 0).all()), bool((obs["agent_1_is_holding"] > 0).all())]
    rp1, hp1 = st.pos.clone(), st.human_pos.clone()
    a = torch.zeros((2, dims), device=dev)
    a[:, offs["agent_0_base_velocity"]] = 1.0
    st, *_ = env.step_fn(st, a)
    ok += [torch.linalg.vector_norm(st.pos - rp1, dim=-1).min().item() > 0.05, torch.equal(st.human_pos, hp1)]

    single = get_config("benchmark/rearrange/pick_procgen.yaml", [
        "habitat.task.actions.humanoid_joint_action.type=HumanoidJointAction",
        "habitat.task.actions.humanoid_joint_action.num_joints=17"])
    env = rearrange_env_from_config(single, num_envs=2, with_visual=False, device=dev)
    st, _ = env.reset_fn()
    p0 = st.pos.clone()
    st, *_ = env.step_fn(st, torch.zeros((2, 100), device=dev))
    ok += [env.action_dim == 100, torch.allclose(st.pos, p0)]
    dirs = np.float32([[1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1]]) * 0.5
    nav = np.stack([ng.is_navigable(env.pack, env._sid(st), p0 + torch.as_tensor(v, device=dev)).cpu().numpy()
                    for v in dirs], 1)
    T = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    T[:, 3, 0:3] = p0.cpu().numpy() + dirs[nav.argmax(1)]
    act = np.zeros((2, 100), np.float32)
    act[:, -16:] = T.reshape(2, 16)
    act[:, -32:-16] = np.eye(4, dtype=np.float32).reshape(16)
    st, *_ = env.step_fn(st, torch.as_tensor(act, device=dev))
    moved = torch.linalg.vector_norm((st.pos - p0)[:, ::2], dim=-1).min().item()
    ok.append(moved > 0.1)
    if not all(ok):
        fail(f"[hab3] the JAX tests' assertions on the card: {ok} (humanoid walked {walked:.3f} m, root moved "
             f"{moved:.3f} m)")
    return dict(walked=walked, root_moved=moved, assertions=len(ok))


def hab3_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card):
    """[hab3]: the two-agent pick_procgen.yaml env at N=128 with the head
    render (the module docstring's 20). Returns its launch counts and #3's
    check on one step's render."""
    import torch

    from habitat_torch.config.default import get_config
    from habitat_torch.core.construct import rearrange_env_from_config
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk

    t_phase = time.perf_counter()
    N, steps = HAB3["num_envs"], HAB3["steps"]
    cfg = get_config("benchmark/rearrange/pick_procgen.yaml", list(HAB3_OVERRIDES))
    env = rearrange_env_from_config(cfg, num_envs=N, device=dev)
    env_c = rearrange_env_from_config(cfg, num_envs=N, with_visual=False, device="cpu")
    h, w = env.render_size
    if not (env.with_humanoid and env.dynamics == "contacts"
            and rc.render_route(env.pack, h, w, "pinhole", dynamic=True) == "index"):
        fail(f"[hab3] the env: humanoid {env.with_humanoid}, dynamics {env.dynamics}")
    setup_s = time.perf_counter() - t_phase
    # the schedule's actions, from the card's states as they come
    zero_counts()
    for p in plain_watch:
        p.start()
    st, _ = env.reset_fn()
    worst, box, dones, held, ms = 0.0, 0.0, 0, 0, []
    for t in range(steps):
        a, _ = hab3_schedule(env, t, st.obj_pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_g = env.step_fn(st, a.to(dev))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out_c = env_c.step_fn(st.to(torch.device("cpu")), a)
        g, b = outputs_agree(f"[hab3] step {t}", out_g, out_c, skip=("robot_head_depth", "robot_head_rgb"),
                             box_bound=HAB3_BOX_BOUND)
        worst, box, dones = max(worst, g), max(box, b), dones + int(out_c[3].sum())
        held += int((out_c[0].human_held >= 0).sum())
        st = out_g[0]
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[hab3]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    launches = path_counts("[hab3] path", raycast_index_t=2 * (1 + steps))
    if not held:
        fail("[hab3] the humanoid never held an object")
    # #3 on the last step's render against its plain version
    index_calls = []

    def index_seen(*args, **k):
        index_calls.append((args, k))
        return rk.raycast_index_t(*args, **k)

    with mock.patch.object(rc, "raycast_index_t", index_seen):
        env._observations(st)
    index_check = {}
    for what, (args, k) in zip(("static", "dynamic"), index_calls):
        got, ref = rk.raycast_index_t(*args, **k), rk.raycast_index_t.plain(*args, **k)
        hit_a, idx_a, dt = agreement(f"[hab3] raycast_index_t on the head render's {what} pass", got, ref)
        index_check[what] = dict(matrix=list(args[0].shape), rays=args[2].numel() // 16, hit_agree=hit_a,
                                 idx_agree=idx_a, max_abs_err=dt)
    a, _ = hab3_schedule(env, 0, st.obj_pos)
    rules = hab3_rules(dev)
    log(f"[hab3] {gpu}: pick_procgen.yaml with a Spot and a humanoid (N={N}, contacts, {h}x{w} head render, "
        f"{len(env._grounded_preds)} predicates, {env.action_dim} action dims over {len(env.action_names)} specs; "
        f"set-up {setup_s:.1f} s): {steps} scheduled steps, ms per env step {[round(x, 1) for x in ms]} (median "
        f"{sorted(ms)[len(ms) // 2]:.2f}); {idle_text(dev, env, st, a.to(dev))}; every step from the card's state on "
        f"the CPU (no camera): largest gap {worst:.3g}, boxes {box:.3g} (bounds {HAB3_BOX_BOUND}), {dones} episodes "
        f"ended, humanoid holding in {held} env-steps; launches {launches} (#3 twice per render), no plain version on "
        f"a card tensor; raycast_index_t on the last step's render against its plain version: " + "; ".join(
            f"{what} {r['matrix']} x {r['rays']} rays hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} |dt| "
            f"{r['max_abs_err']:.3g}" for what, r in index_check.items())
        + f"; the JAX tests' {rules['assertions']} assertions at N=2 (the humanoid walked {rules['walked']:.3f} m, the "
        f"root moved {rules['root_moved']:.3f} m); the phase {time.perf_counter() - t_phase:.1f} s")
    return launches, index_check


def facing_cabinet(env, st, dist=1.5):
    """``st`` with each agent ``dist`` in front of its cabinet's drawer,
    facing it (the drawer slides along art_axis)."""
    import dataclasses

    import torch

    a = env.table.art_target[st.ep_idx]
    base = env.table.art_pos[st.ep_idx, a]
    axis = env.table.art_axis[st.ep_idx, a]
    pos = torch.stack([base[:, 0] + dist * axis[:, 0], st.pos[:, 1], base[:, 2] + dist * axis[:, 2]], dim=-1)
    return dataclasses.replace(st, pos=pos, yaw=torch.atan2(axis[:, 0], axis[:, 2]))


def art_scene_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=ART_SCENE):
    """[art-scene]: the open task on receptacle goals, sampled drawer states
    and the URDF cabinet at N=128 with the 128x128 head render (the module
    docstring's 21). Returns its launch counts and #3's check on a frame
    with the cabinet in view."""
    import numpy as np
    import torch

    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk
    from habitat_torch.tasks.rearrange.art_scene import ART_SAMPLER, art_scene_envs, opener_action

    t_phase = time.perf_counter()
    env, env_c, scenes, episodes = art_scene_envs(os.path.join(ROOT, ART_URDF), dev, **size)
    N, O, A = env.num_envs, env.num_objects, env.num_art
    h, w = env.render_size
    if rc.render_route(env.pack, h, w, "pinhole", dynamic=True) != "index":
        fail("[art-scene] the head render should take the index route")
    # the episodes: goals on receptacles, sampled drawer states, the URDF's travel
    floor = {s.scene_id: s.floor_y for s in scenes}
    on_recep = sum(g[1] > floor[e.scene_id] for e in episodes for g in e.targets.values())
    n_goals = sum(len(e.targets) for e in episodes)
    init_q, goal_q = env_c.table.art_init_q.numpy(), env_c.table.art_goal_q.numpy()
    lo, hi = ART_SAMPLER[2]
    if not on_recep:
        fail("[art-scene] no goal lies on a receptacle")
    if not ((init_q >= lo) & (init_q <= hi)).all():
        fail(f"[art-scene] art_init_q outside the sampler's {ART_SAMPLER[2]}: {init_q.min()}..{init_q.max()}")
    if not np.allclose(goal_q, ART_URDF_OPEN) or env_c.table.art_is_revolute.any():
        fail(f"[art-scene] art_goal_q {np.unique(goal_q)}, want the URDF's {ART_URDF_OPEN} (prismatic)")
    setup_s = time.perf_counter() - t_phase
    # the opener's run, counted: until the first opening (within ART_OPEN's
    # steps) and at least ART_TIMED_STEPS steps
    zero_counts()
    for p in plain_watch:
        p.start()
    st, _ = env.reset_fn()
    acts, ms, opened, q_open, n_open = [], [], None, 0.0, 0
    for t in range(ART_OPEN["steps"]):
        a = opener_action(env, st)
        if t < ART_CHECK_STEPS:
            acts.append(a.cpu())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, _, _, info = env.step_fn(st, a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        now = info["art_obj_at_desired_state"] > 0
        n_open += int(now.sum().item())
        if opened is None and now.any().item():
            opened, q_open = t + 1, info["art_obj_state"].max().item()
        if opened is not None and t + 1 >= ART_TIMED_STEPS:
            break
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[art-scene]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    steps = len(ms)
    launches = path_counts("[art-scene] path", raycast_index_t=2 * (1 + steps))
    if opened is None or not q_open > ART_OPEN["state"]:
        fail(f"[art-scene] no env opened its drawer within {ART_OPEN['steps']} steps (state {q_open:.4f})")
    worst, _, dones = card_vs_cpu_steps("[art-scene]", env, env_c, acts)
    # #3 on one frame with the cabinet in view, against its plain version
    index_calls = []

    def index_seen(*args, **k):
        index_calls.append((args, k))
        return rk.raycast_index_t(*args, **k)

    view = facing_cabinet(env, st)
    with mock.patch.object(rc, "raycast_index_t", index_seen):
        env._observations(view)
    index_check, passes = {}, {}
    for what, (args, k) in zip(("static", "dynamic"), index_calls):
        got, ref = rk.raycast_index_t(*args, **k), rk.raycast_index_t.plain(*args, **k)
        hit_a, idx_a, dt = agreement(f"[art-scene] raycast_index_t on the cabinet frame's {what} pass", got, ref)
        index_check[what] = dict(matrix=list(args[0].shape), rays=args[2].numel() // 16, hit_agree=hit_a,
                                 idx_agree=idx_a, max_abs_err=dt)
        passes[what] = ref
    (t_s, _), (t_d, i_d) = passes["static"], passes["dynamic"]
    cabinet = (i_d >= 12 * O) & (i_d < 12 * (O + A)) & (t_d < t_s)
    view_share = cabinet.float().mean(1)
    index_check["dynamic"]["cabinet_pixel_share_max"] = view_share.max().item()
    if view_share.max().item() < ART_VIEW_SHARE:
        fail(f"[art-scene] the cabinet covers {view_share.max().item():.4f} of the frame at most")
    a = opener_action(env, st)
    med = sorted(ms)[len(ms) // 2]
    log(f"[art-scene] {gpu}: open task on {len(episodes)} episodes (N={N}, {h}x{w} head render, receptacle goals "
        f"{on_recep} of {n_goals}, art_init_q {init_q.min():.4f}..{init_q.max():.4f} in {ART_SAMPLER[2]}, art_goal_q "
        f"{ART_URDF_OPEN} from the URDF; set-up {setup_s:.1f} s): the scripted opener opened a drawer first at "
        f"step {opened} (art_obj_state {q_open:.4f} > {ART_OPEN['state']}), {n_open} openings in {steps} steps; ms "
        f"per env step {[round(x, 1) for x in ms[:8]]}... (median {med:.2f}, min {min(ms):.2f}, max {max(ms):.2f} "
        f"over {steps}); {idle_text(dev, env, st, a)}; launches {launches} (#3 twice per "
        f"render, 1 + {steps} renders), no plain version on a card tensor; {ART_CHECK_STEPS} steps from the card's "
        f"state on the CPU (no camera): largest gap {worst:.3g}, {dones} episodes ended; raycast_index_t on the "
        f"cabinet frame against its plain version: " + "; ".join(
            f"{what} {r['matrix']} x {r['rays']} rays hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} |dt| "
            f"{r['max_abs_err']:.3g}" for what, r in index_check.items())
        + f", the cabinet on {view_share.max().item():.4f} of an env's pixels at most "
        f"(mean {view_share.mean().item():.4f}); the phase {time.perf_counter() - t_phase:.1f} s")
    return launches, index_check


def table_rows(table, idx):
    """The rearrange table of episodes ``idx`` (a LongTensor on its device)."""
    import dataclasses

    nav = table.nav
    nav = dataclasses.replace(nav, extras={k: v[idx] for k, v in nav.extras.items()},
                              **{f.name: getattr(nav, f.name)[idx] for f in dataclasses.fields(nav)
                                 if f.name != "extras"})
    return dataclasses.replace(table, nav=nav, **{f.name: getattr(table, f.name)[idx]
                                                  for f in dataclasses.fields(table) if f.name != "nav"})


def reach_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, rule=REACH_RULE):
    """[reach]: tests/test_rearrange.py's reach recipe trained on the card to
    its rule, the goal table of REACH_GOALS episodes card against CPU, a
    step without host sync, and the batched relations and predicates at
    N=128 card against CPU. No kernel runs on this path."""
    import types

    import numpy as np
    import torch

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.models.policy import make_gaussian_resnet_policy, state_keys_of
    from habitat_torch.sims import kinematic_relationship_manager as krm
    from habitat_torch.sims import sim_utilities as su
    from habitat_torch.tasks.rearrange.generator import make_rearrange_env
    from habitat_torch.tasks.rearrange.rearrange_env import RearrangeBatchedEnv

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    zero_counts()
    for p in plain_watch:
        p.start()
    env = make_rearrange_env(device=dev, **REACH_ENV)
    torch.manual_seed(0)
    policy = make_gaussian_resnet_policy(env.action_dim, has_visual=False, hidden_size=rule["hidden"],
                                         state_keys=state_keys_of(env.observation_shapes), device=dev)
    lrn = PPOLearner(env, policy, PPOConfig(**REACH_PPO),
                     measure_keys=("rearrange_reach_success", "ee_to_resting_distance"), action_type="gaussian")
    rs, succ, walls, trace = lrn.init(seed=0), 0.0, [], []
    for u in range(rule["updates"]):
        sync(dev)
        t0 = time.perf_counter()
        rs, m = lrn.train_step(rs)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        dc = m["done_count"].item()
        if dc > 0:
            succ = m["m_rearrange_reach_success"].item() / dc
        trace.append(round(succ, 3))
        if u > rule["after"] and succ > rule["success"]:
            break
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[reach]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    path_counts("[reach] path")
    if not succ > rule["success"]:
        fail(f"[reach] success {succ:.3f} after {len(walls)} updates, want > {rule['success']} after update "
             f"{rule['after']}")
    st, _ = env.reset_fn()
    a = torch.zeros((env.num_envs, env.action_dim), device=dev)
    env.step_fn(st, a)  # warm up
    no_host_sync("reach", "an env step", lambda: env.step_fn(st, a))
    # the goal table of REACH_GOALS episodes: the episode rows tiled
    env_c = make_rearrange_env(device=cpu, **REACH_ENV)
    E0 = int(env_c.table.obj_init.shape[0])
    rows = torch.arange(REACH_GOALS) % E0
    big_c = RearrangeBatchedEnv(env_c.pack, table_rows(env_c.table, rows), env_c.order.numpy(), task="reach",
                                with_visual=False, control="arm", device=cpu)
    big_g = RearrangeBatchedEnv(env_c.pack, table_rows(env_c.table, rows), env_c.order.numpy(), task="reach",
                                with_visual=False, control="arm", device=dev)
    if not torch.equal(big_g._reach_offsets.cpu(), big_c._reach_offsets):
        fail("[reach] the card's goal offsets differ from the CPU's")
    every = types.SimpleNamespace(ep_idx=torch.arange(REACH_GOALS))
    goal_c = big_c._desired_rest(every)
    goal_g = big_g._desired_rest(types.SimpleNamespace(ep_idx=every.ep_idx.to(dev))).cpu()
    goal_gap = (goal_g - goal_c).abs().max().item()
    goal_equal = share((goal_g == goal_c).all(-1))
    if goal_gap > REACH_GOAL_ATOL:
        fail(f"[reach] the card's goals part from the CPU's by {goal_gap:.3g}")
    # the batched relations and predicates, card against CPU
    rng = np.random.default_rng(0)
    n, o = RELATIONS["num_envs"], RELATIONS["objects"]
    parent = np.where(rng.random((n, o)) < 0.5, rng.integers(0, o, (n, o)), -1)
    parent[np.arange(o)[None].repeat(n, 0) == parent] = -1
    ins = [torch.as_tensor(x) for x in (rng.normal(size=(n, o, 3)).astype(np.float32), parent,
                                        rng.normal(size=(n, o, 3)).astype(np.float32),
                                        rng.normal(size=(n, o, 3)).astype(np.float32),
                                        rng.uniform(-np.pi, np.pi, (n, o)).astype(np.float32))]
    rel_gap = 0.0
    for name, fn, args in (("apply_relations", krm.apply_relations, (ins[0], ins[1], ins[2])),
                           ("apply_relations_rotating", krm.apply_relations_rotating, ins)):
        c = fn(*args)
        g = fn(*(x.to(dev) for x in args)).cpu()
        rel_gap = max(rel_gap, (g - c).abs().max().item())
        if (g - c).abs().max().item() > REACH_GOAL_ATOL:
            fail(f"[reach] {name}: card - CPU {(g - c).abs().max().item():.3g}")
    # boxes and the boxes they rest on (every other one moved 0.3 m off)
    c3, s3 = ins[0].reshape(-1, 3), ins[2].reshape(-1, 3).abs() + 0.1
    s_below = s3.roll(1, 0)
    below = c3 - torch.stack([torch.zeros_like(c3[:, 0]), (s3[:, 1] + s_below[:, 1]) / 2, torch.zeros_like(c3[:, 0])],
                             dim=-1)
    below[::2, 0] += 0.3 + s3[::2, 0]
    pred_agree = []
    for name, fn, args in (("batched_within", su.batched_within, (c3, c3.new_tensor([-1.0, -1.0, -1.0]), s3)),
                           ("batched_ontop", su.batched_ontop, (c3, s3, below, s_below))):
        c, g = fn(*args), fn(*(x.to(dev) for x in args)).cpu()
        if not torch.equal(c, g):
            fail(f"[reach] {name}: {int((c != g).sum())} of {c.numel()} differ card against CPU")
        pred_agree.append(f"{name} {int(c.sum())} of {c.numel()} true")
    log(f"[reach] {gpu}: the reach recipe (N={REACH_ENV['num_envs']}, arm control, blind Gaussian policy hidden "
        f"{rule['hidden']}, T={REACH_PPO['num_steps']}): success {succ:.3f} after {len(walls)} updates (> "
        f"{rule['success']} after update {rule['after']}; trace {trace}); ms per update "
        f"{[round(x, 1) for x in walls[:4]]}... (median {sorted(walls)[len(walls) // 2]:.1f}); no kernel on this "
        f"path, no plain version on a card tensor; an env step makes no host sync; the goal table of {REACH_GOALS} "
        f"episodes: offsets bit-equal card against CPU, goals equal on {goal_equal:.4f} of episodes, largest gap "
        f"{goal_gap:.3g}; apply_relations / apply_relations_rotating at N={n} x {o}: card - CPU {rel_gap:.3g}; "
        + ", ".join(pred_agree) + f" (equal card against CPU); the phase {time.perf_counter() - t_phase:.1f} s")
    return succ


def frame_rule(tag, got, want):
    """tests/test_torch_raycast.py's frame rule on numpy frames: depth within
    1e-4, RGB and semantic ids equal on >= 99.9% of pixels."""
    import numpy as np

    d = float(np.abs(got["depth"] - want["depth"]).max())
    rgb = float((got["rgb"] == want["rgb"]).all(-1).mean())
    sem = float((got["semantic"] == want["semantic"]).mean())
    if not (d <= 1e-4 and rgb >= 0.999 and sem >= 0.999):
        fail(f"{tag}: depth gap {d}, RGB equal {rgb}, ids equal {sem}")
    return d, rgb


def sim_api_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=SIM_API):
    """[sim-api]: the port's TpuSim on the card. Gates: the follower's rule;
    every frame, pose and collision flag against a CPU TpuSim driven by the
    same actions (poses bit-equal, the frame rule); #1 exactly once per
    render (the reset, each step, render_env and its N=1 render_batch, the
    DebugVisualizer's peek) and no plain version on a card tensor; #1 equal
    to its plain version on the sim's own rays; render_env equal to the N=1
    render_batch; the peek against the CPU's by the frame rule;
    sample_navigable_point on the card equal to the CPU's for 4,096 keys.
    Returns #1's launches."""
    import numpy as np
    import torch

    from habitat_torch.ops import navgrid as ng
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk
    from habitat_torch.sims.debug_visualizer import DebugVisualizer
    from habitat_torch.sims.procedural import generate_apartment
    from habitat_torch.sims.tpu_sim import TpuSim, to_host
    from habitat_torch.tasks.shortest_path_follower import ShortestPathFollower
    from habitat_torch.utils import threefry

    t_phase = time.perf_counter()
    scene = generate_apartment(seed=0)
    sim, cpu = TpuSim(None, scene=scene, device=dev), TpuSim(None, scene=scene, device="cpu")
    setup_s = time.perf_counter() - t_phase
    step_ms, gaps = [], []

    def both(action):
        t0 = time.perf_counter()
        got = sim.step(action)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        want = cpu.step(action)
        check(f"step {len(step_ms)}", got, want)

    def check(tag, got, want):
        if not (np.array_equal(sim._pos, cpu._pos) and sim._yaw == cpu._yaw and sim._pitch == cpu._pitch
                and sim._collided == cpu._collided):
            fail(f"[sim-api] {tag}: card pose {sim._pos} {sim._yaw} {sim._collided}, CPU {cpu._pos} {cpu._yaw} "
                 f"{cpu._collided}")
        gaps.append(frame_rule(f"[sim-api] {tag}", got, want))

    zero_counts()
    for p in plain_watch:
        p.start()
    sim.seed(size["seed"]), cpu.seed(size["seed"])
    check("reset", sim.reset(), cpu.reset())
    goal = np.asarray(sim.sample_navigable_point())
    if goal.tolist() != cpu.sample_navigable_point():
        fail("[sim-api] the card sim's goal differs from the CPU's")
    follower = ShortestPathFollower(sim, goal_radius=size["goal_radius"], return_one_hot=False)
    reached, steps = False, 0
    for _ in range(size["max_steps"]):
        a = follower.get_next_action(goal)
        if a == 0:
            reached = True
            break
        both(a)
        steps += 1
    end = float(np.linalg.norm((sim.get_agent_state().position - goal)[[0, 2]]))
    if not (reached and end < size["reach"]):
        fail(f"[sim-api] the follower did not stop at the goal: reached {reached} after {steps} steps, {end:.3f} m")
    both(SIM_TELEPORT)
    for _ in range(size["velocity_steps"]):
        both(SIM_VELOCITY)
    # render_env against the N=1 render_batch at the sim's pose
    cam = torch.tensor(sim._pos + np.float32([0.0, 1.25, 0.0]), device=dev)
    yaw = torch.full((1,), sim._yaw, dtype=torch.float32, device=dev)
    pitch = torch.full((1,), sim._pitch, dtype=torch.float32, device=dev)
    one = rc.render_env(sim.pack, 0, cam, yaw[0], pitch[0], height=128, width=128)
    batch = rc.render_batch(sim.pack, torch.zeros(1, dtype=torch.int64, device=dev), cam[None], yaw, pitch,
                            height=128, width=128)
    if not all(torch.equal(one[k], v[0]) for k, v in batch.items()):
        fail("[sim-api] render_env differs from the N=1 render_batch")
    dbv = DebugVisualizer(sim.pack, resolution=size["dbv"], device=dev)
    peek = dbv.peek("scene").obs_data
    sync(dev)
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[sim-api]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    n_render = 1 + steps + 1 + size["velocity_steps"] + 2 + 1
    launches = path_counts("[sim-api] TpuSim", raycast_fused_sel_t=n_render)
    cpu_peek = DebugVisualizer(cpu.pack, resolution=size["dbv"], device="cpu").peek("scene").obs_data
    peek_eq = float((peek == cpu_peek).all(-1).mean())
    if peek.shape != (*size["dbv"], 3) or peek_eq < 0.999:
        fail(f"[sim-api] DebugVisualizer.peek: shape {peek.shape}, equal to the CPU's on {peek_eq}")
    # #1 against its plain version on the sim's own rays (outside the count)
    kernel, args, kwargs, _ = rc.closest_hit_call(sim.pack, torch.zeros(1, dtype=torch.int64, device=dev), cam[None],
                                                  yaw, pitch, height=128, width=128)
    if kernel is not rk.raycast_fused_sel_t:
        fail(f"[sim-api] the sim's render takes {kernel.__name__}, not #1")
    hit, idx_agree, dt = agreement("[sim-api] #1 on the sim's rays", kernel(*args, **kwargs),
                                   kernel.plain(*args, **kwargs))
    # the device-side sampler: card against CPU, 4,096 keys
    keys = threefry.fold_in(threefry.prng_key(0), np.arange(size["sample_keys"]))
    pts_g = ng.sample_navigable_point(sim.pack, 0, keys).cpu()
    pts_c = ng.sample_navigable_point(cpu.pack, 0, keys)
    if not torch.equal(pts_g, pts_c):
        fail(f"[sim-api] sample_navigable_point: {int((pts_g != pts_c).any(-1).sum())} of {len(keys)} points differ")
    # ms and idle share of a step (move_forward, turns) under the profiler
    prof_acts = [1, 2, 1, 3, 1][:size["profile_steps"]]
    t0 = time.perf_counter()
    for a in prof_acts:
        sim.step(a)
    wall = (time.perf_counter() - t0) * 1e3
    _, dev_ms, n_launch, _ = device_time_and_launches(lambda: [sim.step(a) for a in prof_acts])
    n = len(prof_acts)
    idle = 1 - dev_ms / wall
    log(f"[sim-api] {gpu}: TpuSim on generate_apartment(seed=0) ({sim.pack.tri_attr.shape[1]} triangles padded), "
        f"128x128 depth + RGB; the follower stopped after {steps} steps, {end:.3f} m from the goal (rule: within "
        f"{size['max_steps']} steps, < {size['reach']} m); + a teleport and {size['velocity_steps']} velocity_control "
        f"steps: ms per TpuSim.step {ms_text(step_ms)} over {len(step_ms)} steps (one host copy each); "
        f"#1 {launches['raycast_fused_sel_t']} = 1 + {steps} + 1 + {size['velocity_steps']} + 2 (render_env, "
        f"render_batch) + 1 (peek {size['dbv'][0]}x{size['dbv'][1]}), no plain version on a card tensor; "
        f"{n} profiled steps: {dev_ms / n:.3f} ms on the device and {n_launch / n:.0f} launches per step, idle share "
        f"{idle:.3f} of {wall / n:.3f} ms; every pose and collision flag equal to the CPU sim's, frames: depth gap "
        f"<= {max(g[0] for g in gaps):.3g}, RGB equal on >= {min(g[1] for g in gaps):.5f}; #1 on the sim's rays: "
        f"hit {hit:.6f}, winner {idx_agree:.6f}, |dt| {dt:.3g}; render_env equal to the N=1 render_batch; the peek "
        f"equal to the CPU's on {peek_eq:.5f}; sample_navigable_point equal card against CPU for {len(keys)} keys; "
        f"set-up {setup_s:.1f} s, the phase {time.perf_counter() - t_phase:.1f} s")
    return launches["raycast_fused_sel_t"], dict(ms=step_ms, idle=idle, dev_ms=dev_ms / n, launches=n_launch / n)


def transforms_agree(tag, got, want, nearest_ids):
    """Card transform outputs against the CPU's on the same frames: float
    within 1e-5, uint8 (and ids resampled bilinearly) within 1, ids taken by
    nearest sample equal. Returns the largest float gap."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"[obs-transforms] {tag} {k}: {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} {w.dtype}")
        gap = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
        limit = 1e-5 if w.is_floating_point() else (0.0 if nearest_ids and w.dtype != torch.uint8 else 1.0)
        if gap > limit:
            fail(f"[obs-transforms] {tag} {k}: card against CPU gap {gap} > {limit}")
        if w.is_floating_point():
            worst = max(worst, gap)
    return worst


def obs_transforms_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=OBS_TF):
    """[obs-transforms]: six pinhole cube faces (#1, one render each), the
    native equirect and fisheye frames (#3) at N=32, and the transforms on
    them. Gates: exact launch counts and no plain version on a card tensor;
    each transform on the card equal to the CPU's on the same frames;
    test_projections.py's rules at this size; #1 and #3 equal to their plain
    versions on these frames' rays. Returns ({kernel: launches}, checks)."""
    import numpy as np
    import torch

    from habitat_torch.baselines import obs_transformers as T
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.ops import navgrid as ng
    from habitat_torch.ops import raycast as rc
    from habitat_torch.sims.scene import pack_scenes
    from habitat_torch.utils import threefry

    t_phase = time.perf_counter()
    n, F = size["num_envs"], size["face"]
    scenes, _, _ = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    pack = pack_scenes(scenes).to(dev)
    sids = torch.arange(n, device=dev) % pack.num_scenes
    keys = threefry.fold_in(threefry.prng_key(size["key_seed"]), np.arange(n))
    cam = ng.sample_navigable_point(pack, sids, keys) + torch.tensor([0.0, 1.25, 0.0], device=dev)
    zero = torch.zeros(n, device=dev)

    def render(yaw, pitch, h, w, projection="pinhole"):
        return rc.render_batch(pack, sids, cam, zero + yaw, zero + pitch, height=h, width=w, projection=projection)

    zero_counts()
    for p in plain_watch:
        p.start()
    faces = {f: render(*T._FACE_POSES[f], F, F) for f in T.CUBE_FACES}
    eq = render(0.0, 0.0, *size["eq"], projection="equirect")
    fish = render(0.0, 0.0, *size["fish"], projection="fisheye")
    sync(dev)
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[obs-transforms]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    launches = path_counts("[obs-transforms] renders", raycast_fused_sel_t=6, raycast_index_t=2)
    keys3 = ("rgb", "depth", "semantic")
    cube_obs = {f"{k}_{f.lower()}": faces[f][k] for f in T.CUBE_FACES for k in keys3}
    uuids = [f"{k}_{f.lower()}" for k in keys3 for f in T.CUBE_FACES]
    made = {
        "CubeMap2Equirect": (lambda d: T.CubeMap2Equirect(uuids, size["eq"], device=d), cube_obs, True),
        "CubeMap2Fisheye": (lambda d: T.CubeMap2Fisheye(uuids, size["fish"], device=d), cube_obs, True),
        "Equirect2CubeMap": (lambda d: T.Equirect2CubeMap(list(keys3), (F, F), device=d), eq, False),
        "ResizeShortestEdge": (lambda d: T.ResizeShortestEdge(size=size["resize"], device=d), eq, False),
        "CenterCropper": (lambda d: T.CenterCropper(size["resize"], size["resize"], device=d), eq, False),
        "AddVirtualKeys": (lambda d: T.AddVirtualKeys({"goal_to_agent_gps_compass": 2}, device=d), eq, False),
    }
    outs, ms, gaps = {}, {}, {}
    for name, (make, obs, nearest) in made.items():
        tr_g, tr_c = make(dev), make("cpu")
        outs[name] = tr_g(dict(obs))
        ms[name] = cuda_ms(lambda: tr_g(dict(obs)), size["reps"], warmup=1)
        want = tr_c({k: v.cpu() for k, v in obs.items()})
        gaps[name] = transforms_agree(name, outs[name], want, nearest)
    # test_projections.py's rules at this size
    c2e, native = outs["CubeMap2Equirect"]["rgb"].float(), eq["rgb"].float()
    H = size["eq"][0]
    mid = (c2e[:, H // 4:3 * H // 4] - native[:, H // 4:3 * H // 4]).abs().mean(-1)
    med, under = mid.median().item(), share(mid < 30.0)
    if not (med < 8.0 and under > 0.9):
        fail(f"[obs-transforms] CubeMap2Equirect against the native equirect: median {med}, under 30 {under}")
    b = F // 8
    err = (outs["Equirect2CubeMap"]["depth_front"][:, b:F - b, b:F - b] - faces["FRONT"]["depth"][:, b:F - b, b:F - b])
    e2c_med = err.abs().median().item()
    if e2c_med >= 0.03:
        fail(f"[obs-transforms] Equirect2CubeMap's front face against the native face: median {e2c_med}")
    fimg = outs["CubeMap2Fisheye"]["rgb"]
    fh, fw = size["fish"]
    centre_ok = bool((fimg[:, fh // 2 - 1, fw // 2 - 1].sum(-1) > 0).all())
    corners_zero = bool((fimg[:, 0, 0] == 0).all() and (fimg[:, -1, -1] == 0).all())
    if not (centre_ok and corners_zero):
        fail(f"[obs-transforms] CubeMap2Fisheye: centre valid {centre_ok}, corners masked {corners_zero}")
    # the native fisheye (engine camera) beside the converted one, logged
    fish_gap = (fimg.float() - fish["rgb"].float()).abs().mean().item()
    # each kernel against its plain version on these frames' rays
    checks = {}
    for tag, (yaw, pitch, h, w, proj) in (("#1", (*T._FACE_POSES["FRONT"], F, F, "pinhole")),
                                         ("#3", (0.0, 0.0, *size["eq"], "equirect"))):
        kernel, args, kwargs, _ = rc.closest_hit_call(pack, sids, cam, zero + yaw, zero + pitch, height=h, width=w,
                                                      projection=proj)
        checks[tag] = agreement(f"[obs-transforms] {tag}", kernel(*args, **kwargs), kernel.plain(*args, **kwargs))
    log(f"[obs-transforms] {gpu}: N={n} on the bench's 4 scenes (poses from sample_navigable_point): six {F}x{F} "
        f"faces through #1 (6 launches), the native {size['eq'][0]}x{size['eq'][1]} equirect and "
        f"{size['fish'][0]}x{size['fish'][1]} fisheye through #3 (2), no plain version on a card tensor; ms per "
        f"transform (N={n}, rgb + depth + semantic): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; card against CPU on the same frames: float gap <= {max(gaps.values()):.3g}, uint8 within 1; rules: "
        f"CubeMap2Equirect against the native equirect median {med:.3f} (< 8), {under:.4f} under 30 (> 0.9); "
        f"Equirect2CubeMap front depth median gap {e2c_med:.5f} (< 0.03); the fisheye's centre valid and corners "
        f"masked; converted against the engine's fisheye camera mean RGB gap {fish_gap:.2f} (logged); "
        + "; ".join(f"{t} on these rays: hit {c[0]:.6f}, winner {c[1]:.6f}, |dt| {c[2]:.3g}" for t, c in checks.items())
        + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(ms=ms, checks=checks)


class LogitsRecorder:
    """A policy that keeps the logits of its last call (and is the policy
    otherwise)."""

    def __init__(self, policy):
        self.policy, self.logits = policy, None

    def __call__(self, *args, **kwargs):
        out = self.policy(*args, **kwargs)
        self.logits = out[0].float()
        return out

    def __getattr__(self, name):
        return getattr(self.policy, name)


def sampled_agent_check(dev, env, steps=AGENT_SAMPLED_STEPS):
    """A sampling PPOAgent (flagship export, seed 0) on the card beside the
    same agent on the CPU, both fed the card env's observations. Gates: the
    Gumbel noise of every act bit-equal card against CPU (keys split on the
    host, the (1, A) table copied over); while the two agents have taken the
    same actions, the actions equal wherever the card's noisy logits' top two
    lie more than twice the card-vs-CPU logit gap apart. Returns (steps,
    steps under the rule, steps where the actions part, largest logit gap,
    card ms per act)."""
    import numpy as np
    import torch

    from habitat_torch.baselines.agents.ppo_agents import PPOAgent
    from habitat_torch.baselines.flagship import WEIGHTS
    from habitat_torch.models.convert import load_policy_file
    from habitat_torch.utils import threefry

    agents = [PPOAgent(load_policy_file(WEIGHTS, device=d), deterministic=False, seed=0) for d in (dev, "cpu")]
    recs = [LogitsRecorder(a.policy) for a in agents]
    for a, r in zip(agents, recs):
        a.policy = r
    st, obs = env.reset_fn()
    n_act = agents[0].policy.net.num_actions
    ruled, parted, worst, act_ms, together = 0, [], 0.0, [], True
    for i in range(steps):
        kg, kc = (threefry.split(a._key)[1] for a in agents)
        noise_g = torch.from_numpy(threefry.gumbel(kg, (1, n_act))).to(dev)
        noise_c = torch.from_numpy(threefry.gumbel(kc, (1, n_act)))
        if not torch.equal(noise_g.cpu(), noise_c):
            fail(f"[agents] the sampling agents' Gumbel noise differs card against CPU at act {i}")
        o = {k: v[0] for k, v in obs.items()}
        sync(dev)
        t0 = time.perf_counter()
        a_g = agents[0].act(o)
        act_ms.append((time.perf_counter() - t0) * 1e3)
        a_c = agents[1].act({k: v.cpu() for k, v in o.items()})
        lg = recs[0].logits.cpu()
        gap = (lg - recs[1].logits).abs().max().item()
        worst = max(worst, gap)
        top = np.sort((lg + noise_c)[0].numpy())
        if together and top[-1] - top[-2] > 2 * gap:
            ruled += 1
            if a_g != a_c:
                fail(f"[agents] the sampling agents part at act {i}: {a_g} against {a_c}, margin "
                     f"{top[-1] - top[-2]:.3g}, logit gap {gap:.3g}")
        if a_g != a_c:
            parted.append(i)
            together = False
        st, obs, _, done, _ = env.step_fn(st, torch.tensor([a_g], device=dev))
        if done[0]:
            for a in agents:
                a.reset()
            together = True
    return steps, ruled, parted, worst, act_ms


def vector_env_worker(overrides, device):
    """One [vector-env] worker's env (module level, so a forkserver child
    imports it by name): RLTaskEnv(pointnav_procgen.yaml) with
    ``overrides`` on ``device``; its ``kernel_launches()`` reads #1's count
    in the worker's process and ``zero_launches()`` sets it to 0."""
    from habitat_torch.config.default import get_config
    from habitat_torch.core.environments import RLTaskEnv
    from habitat_torch.ops import raycast_kernels as rk

    env = RLTaskEnv(get_config(ENV_API_CONFIG, list(overrides)), device=device)
    env.kernel_launches = lambda: rk.raycast_fused_sel_t.launches
    env.zero_launches = lambda: setattr(rk.raycast_fused_sel_t, "launches", 0)
    return env


def vec_actions(size=VEC_ENV):
    """(steps, N) actions: forward and turns, with stops at fixed steps."""
    out = []
    for t in range(size["steps"]):
        row = []
        for i in range(size["num_envs"]):
            stop = t in (9 + 7 * i, 40 + 5 * i)
            row.append(0 if stop else (1, 1, 2, 1, 3)[(t + i) % 5])
        out.append(row)
    return out


def same_returns(tag, got, want):
    """A worker's (obs, reward, done, info) equal to the in-process env's."""
    import torch

    (go, gr, gd, gi), (wo, wr, wd, wi) = got, want
    if set(go) != set(wo) or not all(torch.equal(go[k], wo[k]) for k in wo):
        fail(f"{tag}: observations differ from the in-process env's")
    if (gr, gd) != (wr, wd) or dict(gi) != dict(wi):
        fail(f"{tag}: reward/done/info {(gr, gd, dict(gi))}, in-process {(wr, wd, dict(wi))}")


def vector_env_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=VEC_ENV):
    """[vector-env]: ThreadedVectorEnv and VectorEnv (forkserver) of
    size['num_envs'] RLTaskEnv(pointnav_procgen.yaml) workers on the card at
    its 128x128 depth (worker i with habitat.seed 100 + i, the dataset cut
    to size['num_scenes'] x size['episodes_per_scene']). Gates: over
    size['steps'] batched steps with stops (auto-resets), every worker's
    returns equal an in-process card env's given the same actions; #1 once
    per render (the reset, each step, each auto-reset), counted in this
    process for the threads and, in each worker process, set to 0 with
    call before the run and read with call_at after it; no plain version on a card tensor; a step that raises in
    worker 0 makes the parent raise RuntimeError within size['error_s'], and
    close() then leaves no live worker. Returns #1's launches {variant: n}."""
    import torch

    from habitat_torch.core.vector_env import ThreadedVectorEnv, VectorEnv

    t_phase = time.perf_counter()
    n = size["num_envs"]
    overrides = [(f"habitat.seed={100 + i}", f"habitat.dataset.procedural.num_scenes={size['num_scenes']}",
                  f"habitat.dataset.procedural.episodes_per_scene={size['episodes_per_scene']}") for i in range(n)]
    actions = vec_actions(size)
    out, launches = {}, {}
    for name, cls, kw in (("threaded", ThreadedVectorEnv, {}),
                          ("process", VectorEnv, dict(multiprocessing_start_method="forkserver"))):
        t0 = time.perf_counter()
        envs = cls(vector_env_worker, [(ov, dev.type) for ov in overrides], device=dev, **kw)
        setup_s = time.perf_counter() - t0
        zero_counts()
        envs.call(["zero_launches"] * n)  # the worker processes' own counts
        for p in plain_watch:
            p.start()
        first, steps, ms = envs.reset(), [], []
        for a in actions:
            t0 = time.perf_counter()
            steps.append(envs.step(a))
            ms.append((time.perf_counter() - t0) * 1e3)
        sync(dev)
        for p in plain_watch:
            p.stop()
        if plain_on_card:
            fail(f"[vector-env] {name}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        dones = sum(int(r[2]) for row in steps for r in row)
        renders = n + n * len(actions) + dones
        if name == "threaded":
            launches[name] = path_counts("[vector-env] threaded", raycast_fused_sel_t=renders)["raycast_fused_sel_t"]
        else:
            path_counts("[vector-env] process (the parent)")
            launches[name] = sum(envs.call_at(i, "kernel_launches") for i in range(n))
            if launches[name] != renders:
                fail(f"[vector-env] process: the workers launched #1 {launches[name]} times, want {renders}")
        # a step that raises in worker 0: forwarded within the deadline
        t0 = time.perf_counter()
        try:
            envs.step(["fly"] + [1] * (n - 1))
            fail(f"[vector-env] {name}: a worker's error did not reach the parent")
        except RuntimeError as e:
            if "worker 0" not in str(e) or "'step'" not in str(e):
                fail(f"[vector-env] {name}: the forwarded error does not name the worker and command: {e}")
        err_s = time.perf_counter() - t0
        if err_s > size["error_s"]:
            fail(f"[vector-env] {name}: the error took {err_s:.1f} s to reach the parent")
        envs.close()
        live = [w.index for w in envs._workers if w.alive()]
        if live:
            fail(f"[vector-env] {name}: workers {live} still alive after close()")
        out[name] = dict(ms=ms, setup_s=setup_s, err_s=err_s, dones=dones, first=first, steps=steps)
    # every worker of both variants against an in-process card env given the same actions
    for i in range(n):
        ref = vector_env_worker(overrides[i], dev)
        obs = ref.reset()
        for name, run in out.items():
            if not all(torch.equal(run["first"][i][k], obs[k]) for k in obs):
                fail(f"[vector-env] {name} worker {i}: the reset differs from the in-process env's")
        for t, a in enumerate(actions):
            want = ref.step(a[i])
            if want[2]:
                want = (ref.reset(), *want[1:])
            for name, run in out.items():
                same_returns(f"[vector-env] {name} worker {i} step {t}", run["steps"][t][i], want)
    log(f"[vector-env] {gpu}: {n} RLTaskEnv(pointnav_procgen.yaml) workers, 128x128 depth, {len(actions)} batched "
        f"steps with stops: " + "; ".join(
            f"{k}: ms per batched step {ms_text(v['ms'])}, #1 {launches[k]} = {n} + {n} x {len(actions)} + "
            f"{v['dones']} auto-resets, set-up {v['setup_s']:.1f} s, a worker's error raised in the parent after "
            f"{v['err_s']:.2f} s" for k, v in out.items())
        + f"; every worker's returns equal an in-process card env's, no plain version on a card tensor, no live "
        f"worker after close(); the phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def gif_frames(path):
    """(frames, width, height, delays in cs) of a GIF, read block by block."""
    import struct

    raw = open(path, "rb").read()
    if raw[:6] != b"GIF89a":
        fail(f"{path} is not a GIF89a")
    w, h, packed = struct.unpack("<HHB", raw[6:11])
    at = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays = 0, []

    def skip_sub_blocks(at):
        while raw[at]:
            at += raw[at] + 1
        return at + 1

    while raw[at] != 0x3B:
        if raw[at] == 0x21:
            if raw[at + 1] == 0xF9:
                delays.append(struct.unpack("<H", raw[at + 4:at + 6])[0])
            at = skip_sub_blocks(at + 2)
        elif raw[at] == 0x2C:
            flags = raw[at + 9]
            at += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            at = skip_sub_blocks(at + 1)
            frames += 1
        else:
            fail(f"{path}: unknown GIF block {raw[at]:#x} at {at}")
    return frames, w, h, delays


def eval_video_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=EVAL_VIDEO):
    """[eval-video]: evaluate_agent with the flagship policy on the flagship
    env (its first size['num_scenes'] held-out scenes, 128x128 depth) at
    N=size['num_envs'], one episode per env, greedy, video_option=("disk",)
    with a TopDownMapTracker of env 0's scene. Gates: the metrics equal those
    of the same eval without video; #1 once per render and no plain version
    on a card tensor; the GIF holds one frame per recorded step, each
    delayed round(100 / fps) cs; every frame given to generate_video equals
    observations_to_image of that step's card observation and the tracker's
    map (a run with a step recorder). Then DebugVisualizer.make_debug_video
    over a card TpuSim (one GIF frame per peek, #1 once per peek) and
    DebugObservation.save (the PNG decodes to the image). Returns #1's
    launches of the recorded eval."""
    import tempfile

    import numpy as np
    import torch

    import habitat_torch.utils.common as common
    from habitat_torch.baselines import flagship
    from habitat_torch.baselines.evaluator import evaluate_agent
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.datasets.pointnav import make_procedural_pointnav
    from habitat_torch.models.convert import load_policy_file
    from habitat_torch.sims.debug_visualizer import DebugVisualizer
    from habitat_torch.sims.loaders import decode_png
    from habitat_torch.sims.procedural import generate_apartment
    from habitat_torch.sims.tpu_sim import TpuSim
    from habitat_torch.utils.visualizations.image_io import gif_delay_cs
    from habitat_torch.utils.visualizations.maps import TopDownMapTracker
    from habitat_torch.utils.visualizations.utils import observations_to_image

    t_phase = time.perf_counter()
    p = flagship.PROTOCOL
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=size["num_scenes"],
                                                        episodes_per_scene=p["episodes_per_scene"],
                                                        seed=p["scene_seed"])
    env = make_nav_env(scenes, episodes, num_envs=size["num_envs"], precomputed_fields=fields,
                       max_episode_steps=p["max_episode_steps"], device=dev,
                       sensor_specs=(("HabitatSimDepthSensor", {"height": p["res"], "width": p["res"]}),
                                     ("PointGoalWithGPSCompassSensor", None)))
    policy = load_policy_file(flagship.WEIGHTS, device=dev)
    st, _ = env.reset_fn()
    scene0 = scenes[int(env.table.scene_idx[st.ep_idx[0]].item())]
    kw = dict(episodes_per_env=1, deterministic=True)
    step_fn, steps = env.step_fn, []

    def counted(*a):
        steps.append(1)
        return step_fn(*a)

    def timed(**extra):
        env.step_fn = counted
        steps.clear()
        sync(dev)
        t0 = time.perf_counter()
        m = evaluate_agent(env, policy, **kw, **extra)
        sync(dev)
        env.step_fn = step_fn
        return m, (time.perf_counter() - t0) * 1e3 / len(steps), len(steps)

    with tempfile.TemporaryDirectory() as tmp:
        plain, plain_ms, n_steps = timed()
        zero_counts()
        for q in plain_watch:
            q.start()
        video, video_ms, n_video = timed(video_option=("disk",), video_dir=os.path.join(tmp, "a"),
                                         map_tracker=TopDownMapTracker(scene0), checkpoint_idx=1)
        sync(dev)
        for q in plain_watch:
            q.stop()
        if plain_on_card:
            fail(f"[eval-video]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        launches = path_counts("[eval-video] recorded eval", raycast_fused_sel_t=1 + n_video)
        if video != plain or n_video != n_steps:
            fail(f"[eval-video] metrics with video {video} ({n_video} steps), without {plain} ({n_steps})")
        # the frames against observations_to_image of each step's card observation
        frames, seen = [], []
        generate = common.generate_video

        def keep(video_option, video_dir, images, **k):
            frames.extend(images)
            return generate(video_option, video_dir, images, **k)

        def record(state, action):
            out = step_fn(state, action)
            s, obs, _, done = out[:4]
            seen.append((obs["depth"][0].cpu().numpy(), s.pos[0].cpu().numpy(), float(s.yaw[0]), bool(done[0])))
            return out

        env.step_fn = record
        with mock.patch.object(common, "generate_video", keep):
            evaluate_agent(env, policy, **kw, video_option=("disk",), video_dir=os.path.join(tmp, "b"),
                           map_tracker=TopDownMapTracker(scene0), checkpoint_idx=1)
        env.step_fn = step_fn
        tracker = TopDownMapTracker(scene0)
        n_rec = next(k for k, r in enumerate(seen) if r[3]) + 1  # env 0's quota closes at its first done
        if len(frames) != n_rec:
            fail(f"[eval-video] {len(frames)} frames for {n_rec} recorded steps")
        for k, (depth, pos, yaw, done) in enumerate(seen[:n_rec]):
            tracker.update(pos, yaw)
            want = observations_to_image({"depth": depth}, {"top_down_map": tracker.frame()})
            if not np.array_equal(frames[k], want):
                fail(f"[eval-video] frame {k} differs from observations_to_image of the step's observation")
            if done:
                tracker.reset()
        (name,) = os.listdir(os.path.join(tmp, "a"))
        n_gif, gw, gh, delays = gif_frames(os.path.join(tmp, "a", name))
        gif_bytes = os.path.getsize(os.path.join(tmp, "a", name))
        if (n_gif, gh, gw) != (n_rec, *frames[0].shape[:2]) or set(delays) != {gif_delay_cs(10)}:
            fail(f"[eval-video] {name}: {n_gif} frames of {gw}x{gh}, delays {set(delays)}; want {n_rec} of "
                 f"{frames[0].shape[1]}x{frames[0].shape[0]}, {gif_delay_cs(10)} cs")
        # the debug camera over a card TpuSim
        sim = TpuSim(None, scene=generate_apartment(seed=0), device=dev)
        dbv = DebugVisualizer(sim.pack, resolution=size["dbv"], device=dev)
        zero_counts()
        for subject in size["peeks"]:
            dbv.peek(subject)
        obs = dbv.get_observation(look_at=[3.0, 0.5, 3.0], look_from=[1.0, 1.5, 1.0])
        path_counts("[eval-video] debug camera", raycast_fused_sel_t=len(size["peeks"]) + 1)
        dbv.make_debug_video(tmp, prefix="dbv")
        n_dbv = gif_frames(os.path.join(tmp, "dbv.gif"))[0]
        obs.show_point(np.array([0.5, 0.5]))
        png = obs.save(tmp, "dbg")
        decoded = np.round(decode_png(open(png, "rb").read()) * 255).astype(np.uint8)
        if n_dbv != len(size["peeks"]) or not np.array_equal(decoded, obs.get_image()):
            fail(f"[eval-video] debug video {n_dbv} frames (want {len(size['peeks'])}), PNG equal to the image: "
                 f"{np.array_equal(decoded, obs.get_image())}")
    log(f"[eval-video] {gpu}: the flagship policy on {size['num_scenes']} flagship scenes, N={size['num_envs']}, one "
        f"greedy episode per env: {n_steps} eval steps, ms per eval step {plain_ms:.3f} without recording and "
        f"{video_ms:.3f} recording env 0 (its frame in the step's one host copy); metrics equal with and without "
        f"video ({', '.join(f'{k} {v:.4f}' for k, v in sorted(plain.items()))}); #1 {launches['raycast_fused_sel_t']}"
        f" = 1 + {n_video}, no plain version on a card tensor; {name}: {n_gif} frames of {gw}x{gh} "
        f"({gif_bytes} bytes), each {delays[0]} cs, every frame equal to observations_to_image of its step's card "
        f"observation; DebugVisualizer.make_debug_video over a card TpuSim: {n_dbv} frames of "
        f"{size['dbv'][0]}x{size['dbv'][1]}, #1 once per peek; DebugObservation.save's PNG equal to its image; "
        f"the phase {time.perf_counter() - t_phase:.1f} s")
    return launches["raycast_fused_sel_t"]


CLIP_YAML = """# @package _global_
defaults:
  - /benchmark/nav/{task}: {task}_procgen
  - /habitat_baselines: habitat_baselines_rl_config_base
  - _self_
"""


def clip_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card, size=CLIP):
    """[clip]: PPO with the frozen CLIP-RN50 backbones through
    trainer_from_config, one update at N=size['num_envs'], T=size['num_steps']
    (PPO's 4 epochs x 2 minibatches), on pointnav_procgen.yaml with
    resnet50_clip_attnpool (128x128 depth through the trunk) and on
    objectnav_procgen.yaml with resnet50_clip_avgpool (128x128 RGB and depth,
    the summed maps). Gates: finite losses; #1 once per render (1 + T) and
    no plain version on a card tensor; the trunk's weights bit-unchanged
    after the update while visual_fc moves; the encoder's features on the
    first size['check_envs'] envs' reset observations equal the CPU port's
    at the same weights within 2**-6 of the largest |feature| (the bf16 rule
    of tests/test_torch_clip.py). Returns #1's launches {config: n}."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from habitat_torch.config.default import get_config
    from habitat_torch.core import construct

    t_phase = time.perf_counter()
    launches, texts = {}, []
    for task, backbone, sensors in (("pointnav", "resnet50_clip_attnpool", ("depth",)),
                                    ("objectnav", "resnet50_clip_avgpool", ("rgb", "depth"))):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{task}.yaml")
            with open(path, "w") as f:
                f.write(CLIP_YAML.format(task=task))
            cfg = get_config(path, [f"habitat_baselines.rl.ddppo.backbone={backbone}",
                                    f"habitat_baselines.num_environments={size['num_envs']}",
                                    f"habitat_baselines.rl.ppo.num_steps={size['num_steps']}",
                                    "habitat_baselines.tensorboard_dir=",
                                    f"habitat_baselines.checkpoint_folder={tmp}/ckpt",
                                    f"habitat.dataset.procedural.num_scenes={size['num_scenes']}"])
            t0 = time.perf_counter()
            trainer = construct.trainer_from_config(cfg, device=dev)
            setup_s = time.perf_counter() - t0
        policy, env, lrn = trainer.policy, trainer.env, trainer.learner
        enc = policy.net.encoder
        if type(enc).__name__ != "ResNetCLIPEncoder" or enc.visual_inputs != sensors:
            fail(f"[clip] {task}: the policy's encoder is {type(enc).__name__} over {enc.visual_inputs}")
        trunk0 = {k: v.clone() for k, v in enc.backbone.state_dict().items()}
        fc0 = policy.net.visual_fc.weight.detach().clone()
        zero_counts()
        for q in plain_watch:
            q.start()
        rs, walls, roll, upd, metrics = recipe_run(f"[clip] {task}", lrn, 1, dev)
        sync(dev)
        for q in plain_watch:
            q.stop()
        if plain_on_card:
            fail(f"[clip] {task}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        launches[task] = path_counts(f"[clip] {task}",
                                     raycast_fused_sel_t=1 + size["num_steps"])["raycast_fused_sel_t"]
        if not all(torch.equal(v, trunk0[k]) for k, v in enc.backbone.state_dict().items()):
            fail(f"[clip] {task}: the frozen trunk changed in the update")
        if any(p.grad is not None for p in enc.backbone.parameters()):
            fail(f"[clip] {task}: a gradient reached the frozen trunk")
        if torch.equal(policy.net.visual_fc.weight, fc0):
            fail(f"[clip] {task}: visual_fc did not move in the update")
        # the features of the first envs' reset observations, card against CPU
        _, obs = env.reset_fn()
        k = size["check_envs"]
        vis = {s: obs[s][:k] for s in sensors}
        got = enc(vis).float().cpu().numpy()
        want = copy.deepcopy(enc).cpu()({s: v.cpu() for s, v in vis.items()}).numpy()
        gap, span = float(np.abs(got - want).max()), 2.0 ** -6 * float(np.abs(want).max())
        if not gap <= span:
            fail(f"[clip] {task}: card features {gap:.3g} from the CPU's, allowed {span:.3g}")
        # one rollout step (policy act + env step) under the profiler
        st, obs = env.reset_fn()
        hidden = policy.initial_hidden(env.num_envs)
        prev = torch.zeros(env.num_envs, dtype=torch.int32, device=dev)
        masks = torch.zeros(env.num_envs, device=dev)

        def act_step():
            with torch.no_grad():
                logits, _, _ = policy(obs, hidden, prev, masks)
            return env.step_fn(st, logits.argmax(-1).to(torch.int32))

        step_ms = wall_ms(dev, act_step, 3)
        _, dev_ms, n_launch, _ = device_time_and_launches(lambda: [act_step() for _ in range(2)])
        texts.append(
            f"{task}_procgen.yaml + {backbone} ({'+'.join(sensors)} 128x128 through the trunk, visual_fc "
            f"{policy.net.visual_fc.in_features} -> {policy.net.visual_fc.out_features}): rollout {roll[0]:.1f} ms "
            f"({roll[0] / size['num_steps']:.2f} ms per rollout step), update {upd[0]:.1f} ms, losses "
            + ", ".join(f"{m} {v:.4f}" for m, v in metrics.items() if m.startswith("losses/"))
            + f"; a rollout step alone {step_ms:.2f} ms, {dev_ms / 2:.2f} ms on the device, idle share "
            f"{1 - dev_ms / (2 * step_ms):.3f}, {n_launch / 2:.0f} launches; #1 {launches[task]} = 1 + "
            f"{size['num_steps']}; trunk bit-unchanged, visual_fc moved; features card - CPU {gap:.3g} "
            f"(allowed {span:.3g}) on {k} envs; set-up {setup_s:.1f} s")
        del trainer, policy, env, lrn, rs
        torch.cuda.empty_cache()
    log(f"[clip] {gpu}: one update of N={size['num_envs']}, T={size['num_steps']} through trainer_from_config: "
        + "; ".join(texts) + f"; no plain version on a card tensor; the phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "habitat_torch")):
        print("chip_smoke: run from a checkout of the repository (habitat_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from habitat_torch.baselines.ppo import PPOConfig, PPOLearner
    from habitat_torch.core.batched_env import BatchedEnv
    from habitat_torch.core.env_factory import make_nav_env
    from habitat_torch.core.registry import registry
    import numpy as np

    from habitat_torch.datasets.pointnav import generate_pointnav_episode, make_procedural_pointnav
    from habitat_torch.models.policy import make_pointnav_resnet_policy
    from habitat_torch.ops import cuda_build, pool
    from habitat_torch.ops import raycast as rc
    from habitat_torch.ops import raycast_kernels as rk
    from habitat_torch.sims.procedural import build_lod_scene, generate_scan_apartment

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gpu = gpu_name_and_power()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} card {gpu}")

    # ---- 1. build -------------------------------------------------------
    for name, (secs, ptxas) in cuda_build.build().items():  # every source, nvcc in parallel
        log(f"[build] {name}.cu done {secs:.1f} s after the start")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")

    # ---- scenes and envs (host generation counts as set-up) ------------
    sensors = (
        ("HabitatSimDepthSensor", {"height": BENCH["height"], "width": BENCH["width"]}),
        ("HabitatSimRGBSensor", {"height": BENCH["height"], "width": BENCH["width"]}),
        ("PointGoalWithGPSCompassSensor", None),
    )
    scenes, episodes, fields = make_procedural_pointnav(num_scenes=4, episodes_per_scene=16, seed=0)
    env = make_nav_env(
        scenes, episodes, num_envs=BENCH["num_envs"], precomputed_fields=fields,
        max_episode_steps=500, sensor_specs=sensors,
    )
    torch.manual_seed(0)
    policy = make_pointnav_resnet_policy(len(env.actions), backbone="resnet18", hidden_size=512)
    mscenes, meps, mfields = make_procedural_pointnav(
        num_scenes=1, episodes_per_scene=4, seed=0, extent=MID["extent"],
        scene_kw=dict(n_clutter=MID["n_clutter"]),
    )
    mid_env = make_nav_env(
        mscenes, meps, num_envs=MID["num_envs"], precomputed_fields=mfields,
        max_episode_steps=500, sensor_specs=sensors,
    )
    log(f"[setup] bench pack {tuple(env.pack.tri_mat.shape)}, mid pack {tuple(mid_env.pack.tri_mat.shape)}, "
        f"{time.perf_counter() - t_start:.1f} s")
    t_scan = time.perf_counter()
    scan_scene = generate_scan_apartment(0, tess=SCAN["tess"], n_clutter=SCAN["n_clutter"])
    lod = build_lod_scene(scan_scene, cells=SCAN["cells"], bands=SCAN["bands"])
    lod.scene_id = scan_scene.scene_id
    if lod.num_triangles != SCAN["triangles"]:
        fail(f"the scan scene has {lod.num_triangles} triangles, expected {SCAN['triangles']}")
    erng = np.random.default_rng(0)
    pairs = [generate_pointnav_episode(scan_scene, str(i), erng) for i in range(16)]
    pairs = [p for p in pairs if p is not None]
    scan_env = make_nav_env(
        [lod], [p[0] for p in pairs], num_envs=BENCH["num_envs"], max_episode_steps=500,
        precomputed_fields={e.episode_id: f for (e, f) in pairs}, sensor_specs=sensors,
    )
    spack = scan_env.pack
    pack_bytes = sum(v.numel() * v.element_size() for v in vars(spack).values() if isinstance(v, torch.Tensor))
    log(f"[setup] scan scene {lod.num_triangles} triangles, {len(pairs)} episodes, pack {tuple(spack.tri_mat.shape)} "
        f"in chunks of {spack.tri_mat.shape[3] // spack.chunk_bounds.shape[1]}, {pack_bytes / 1e6:.1f} MB on the card, "
        f"{time.perf_counter() - t_scan:.1f} s")
    # the panoramic cameras: the bench configuration, and the scan env's
    # scenes, episodes and pack (shared on the card) at N=32
    pano_sensors = (
        ("HabitatSimEquirectangularDepthSensor", PANO),
        ("HabitatSimEquirectangularRGBSensor", PANO),
        ("PointGoalWithGPSCompassSensor", None),
    )
    pano_env = make_nav_env(
        scenes, episodes, num_envs=BENCH["num_envs"], precomputed_fields=fields,
        max_episode_steps=500, sensor_specs=pano_sensors,
    )
    pano_scan_env = BatchedEnv(
        scan_env.pack, scan_env.table, scan_env.order[:PANO_SCAN["num_envs"]].cpu().numpy(),
        [registry.get_sensor(name)(cfg) for name, cfg in pano_sensors], scan_env.measures, scan_env.actions,
        device=dev, max_episode_steps=500,
    )

    # ---- 2. kernels -------------------------------------------------------
    wrappers = {n: getattr(rk, n) for n in (
        "raycast_fused_sel_t", "raycast_fused_t", "raycast_exactsel_t", "raycast_stream_t", "cullmask_t",
        "raycast_index_t", "raycast_culled_t", "raycast_index", "raycast_culled", "raycast_tilecull_t")}
    wrappers["max_pool_3x3s2_bwd"] = pool.max_pool_3x3s2_bwd

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def path_counts(path, **want):
        """The launch counts since zero_counts(); fails unless they are
        exactly ``want`` (kernels not named: no launch)."""
        got = {n: w.launches for n, w in wrappers.items()}
        if got != {**dict.fromkeys(wrappers, 0), **want}:
            fail(f"{path} launches {got}, want {want} and no other")
        return got

    cam_offset = torch.tensor([0.0, 1.25, 0.0], device=dev)
    hw = dict(height=BENCH["height"], width=BENCH["width"])

    def reset_render_call(e, size=hw, **kw):
        """The closest-hit call of an env's reset render: its first render inputs."""
        st, _ = e.reset_fn()
        return rc.closest_hit_call(e.pack, e._make_ctx(st).sid, st.pos + cam_offset, st.yaw, st.pitch, **size, **kw)

    kernel, args, kwargs, fused_sel_B = reset_render_call(env)
    if kernel is not rk.raycast_fused_sel_t:
        fail("bench scenes should take the frustum-selected kernel")
    fused_sel_args, fused_sel_kwargs = args, kwargs  # also #10's inputs (fused_sel_B: their rays)
    cnt = args[3]
    n_tests = int(cnt.sum().item()) * 32 * kwargs["ray_tile"]
    sel = ring_row("raycast_fused_sel_t", kernel, args, kwargs, n_tests, rk.fused_design(32), BENCH["width"])
    sel["replaces"] = "habitat_tpu/ops/raycast_pallas.py:623"
    sel["survivor_chunks_mean"] = cnt.float().mean().item()

    # every-chunk kernel at the mid-size route's shape, on its reset render
    kernel, args, kwargs, _ = reset_render_call(mid_env)
    if kernel is not rk.raycast_fused_t:
        fail("the mid-size scene should take the every-chunk kernel")
    n_tests = MID["num_envs"] * BENCH["height"] * BENCH["width"] * mid_env.pack.tri_attr.shape[1]
    fused128 = rk.fused_design(128)
    every = ring_row("raycast_fused_t", kernel, args, kwargs, n_tests, fused128, BENCH["width"], reps=20,
                     plain_reps=1)
    every["replaces"] = "habitat_tpu/ops/raycast_pallas.py:482"

    # and on a synthetic 8192-triangle pack, N=8 (twice the mid scene's chunks)
    g = torch.Generator().manual_seed(0)
    T = 8192
    v0 = torch.rand(T, 3, generator=g) * 8 - 4
    e1, e2 = torch.randn(T, 3, generator=g) * 0.4, torch.randn(T, 3, generator=g) * 0.4
    tm = torch.from_numpy(rc.build_tri_matrix(v0.numpy(), e1.numpy(), e2.numpy(), torch.ones(T, dtype=torch.bool).numpy()))
    gm = rc.group_tri_mat(tm[None], 128).contiguous().to(dev)
    n = 8
    pos = (torch.rand(n, 3, generator=g) - 0.5).to(dev)
    yaw = (torch.rand(n, generator=g) * 6.283 - 3.1416).to(dev)
    B = rc.ray_feature_matrix(pos, yaw, torch.zeros(n, device=dev))
    Bt = torch.nn.functional.pad(B.transpose(1, 2), (0, 0, 0, 6)).contiguous()
    _, d_t, _, _, rt = rc.pinhole_constants(90.0, BENCH["height"], BENCH["width"], dev)
    sids = torch.zeros(n, dtype=torch.int32, device=dev)
    n_tests = n * BENCH["height"] * BENCH["width"] * T
    synth = ring_row(
        "raycast_fused_t", rk.raycast_fused_t, (gm, sids, d_t, Bt), dict(ray_tile=rt, tri_chunk=128),
        n_tests, fused128, BENCH["width"], reps=10, plain_reps=1,
    )
    every["synthetic_8192_tris_n8"] = {k: synth[k] for k in (
        "max_abs_err", "hit_agree", "idx_agree", "rays_differing", "ms", "plain_ms", "bound_ms", "bound_by",
        "bound_old_rule_ms", "inside_pairs")}
    # the scan route's kernels on the scan env's reset render
    stream_src = "habitat_torch/csrc/raycast_stream.cu"
    R = BENCH["height"] * BENCH["width"]
    n_blocks = BENCH["num_envs"] * R // rk.STREAM_BLOCK_RAYS
    stream_design = kernel_design("raycast_stream", rk.stream_design(), rk.STREAM_BLOCK_RAYS, rk.STREAM_STAGES,
                                  warp_rays=rk.STREAM_WARP_RAYS, tile_width=32)
    stream_rows = []
    for name, backend, line, reps in (("raycast_exactsel_t", "auto", 1464, 10), ("raycast_stream_t", "stream", 1143, 3)):
        kernel, args, kwargs, _ = reset_render_call(scan_env, backend=backend)
        if kernel is not getattr(rk, name) or args[4].shape != (R // 1024, 8, 1024):
            fail(f"the scan env's {backend} route should take {name} on {R // 1024} tiles of 1024 rays")
        ids, cnt, C = args[2], args[3], kwargs["tri_chunk"]
        tested = {"block": 0, "warp": 0}
        # inside pairs are counted over the slots where a ray is still open,
        # a few more than its final hit needs
        row = compare_kernel(
            name, kernel, args, kwargs, lambda t, i: needed_tests(ids, cnt, t, C, 1024),
            reps=reps, plain_reps=0, source=stream_src, plain_kwargs=dict(tested=tested),
            n_inside=lambda t, i: tested["inside"],
        )
        row["replaces"] = f"habitat_tpu/ops/raycast_pallas.py:{line}"
        warps = n_blocks * rk.STREAM_BLOCK_RAYS // rk.STREAM_WARP_RAYS
        row.update(
            tri_chunk=C, list_slots=ids.shape[2], listed_per_tile_mean=cnt.float().mean().item(),
            staged_per_block_mean=tested["block"] / n_blocks, computed_per_warp_mean=tested["warp"] / warps,
            needed_per_ray_mean=row["ray_tri_tests"] / C / (n_blocks * rk.STREAM_BLOCK_RAYS), design=stream_design,
        )
        stream_rows.append(row)
        log(f"[kernel] {name} (C={C}) on the scan reset: hit {row['hit_agree']:.6f} idx {row['idx_agree']:.6f} "
            f"|dt| {row['max_abs_err']:.3g}, {row['nearer_in_plain_rays']} rays nearer in the plain version; "
            f"{row['ms']:.3f} ms (plain {row['plain_ms']:.0f} ms, bound {row['bound_ms']:.3f} ms by {row['bound_by']}); "
            f"per tile {row['listed_per_tile_mean']:.1f} listed of {ids.shape[2]} slots, per "
            f"{rk.STREAM_BLOCK_RAYS}-ray block {row['staged_per_block_mean']:.1f} staged, per "
            f"{rk.STREAM_WARP_RAYS}-ray warp {row['computed_per_warp_mean']:.1f} computed, per ray "
            f"{row['needed_per_ray_mean']:.1f} needed by its final hit, {row['inside_pairs']} inside pairs of open rays; "
            f"{design_text(stream_design)}")
    exact_row, stream_row = stream_rows

    # the cull mask on the head that the same reset's selection produces
    st0, _ = scan_env.reset_fn()
    sid0, cam0 = scan_env._make_ctx(st0).sid.to(torch.int32), (st0.pos + cam_offset).float()
    _, _, _, planes_b, _ = rc.block_constants(90.0, BENCH["height"], BENCH["width"], cam0.device)
    dirs_b = rc.to_blocks(rc.world_rays(st0.yaw, st0.pitch, 90.0, **hw), **hw)
    ids0, cnt0 = rc.select_chunks(
        spack.chunk_bounds[sid0.long()], cam0[:, None, :].expand(-1, R, -1), dirs_b, 1024, 320, with_cnt=True
    )
    sel_args = (spack.tri_v0, spack.tri_e1, spack.tri_e2, spack.tri_valid, spack.chunklet_ab32, sid0, cam0,
                st0.yaw, st0.pitch, planes_b, ids0, cnt0)
    sel_kw = dict(parent_c=spack.tri_mat.shape[3] // spack.chunk_bounds.shape[1], c=32)
    # the level-1 survivors' nearest 384: the head of the packed-exact flow
    head, cntk = rc.select_chunklets_exact(*sel_args, k_final=384, **sel_kw)
    nw = torch.einsum("nij,kpj->nkpi", rc.view_rotation_matrix(st0.yaw, st0.pitch), planes_b).contiguous()
    cull_args = (spack.tri_verts16, sid0, head, cntk, nw, cam0)
    before = rk.cullmask_t.launches
    mask_k = rk.cullmask_t(*cull_args)
    torch.cuda.synchronize()
    if rk.cullmask_t.launches != before + 1:
        fail("cullmask_t: wrapper did not launch its kernel")
    mask_p = rk.cullmask_t.plain(*cull_args)
    gate = torch.arange(head.shape[2], device=dev) < cntk[..., None]
    mask_agree = share(mask_k[gate] == mask_p[gate])
    # the chunklet lists built from the kernel's mask and, with the wrapper
    # swapped for its plain version in this script only, from the plain mask
    with_plain_mask = mock.patch.object(rc, "cullmask_t", rk.cullmask_t.plain)
    lists = {"kernel": rc.select_chunklets_exact(*sel_args, verts16=spack.tri_verts16, **sel_kw)}
    with with_plain_mask:
        lists["plain"] = rc.select_chunklets_exact(*sel_args, verts16=spack.tri_verts16, **sel_kw)
    if rk.cullmask_t.launches != before + 2:
        fail("select_chunklets_exact on card tensors did not launch the cull-mask kernel exactly once")
    differing = int(((lists["plain"][0] != lists["kernel"][0]).any(-1) | (lists["plain"][1] != lists["kernel"][1])).sum().item())
    if mask_agree < 0.9999 or differing:
        fail(f"cullmask_t: mask agreement {mask_agree}, {differing} tiles with another chunklet list")
    gated = int(gate.sum().item())
    # bytes the test needs: each distinct 2 KB chunklet row once (tiles share rows)
    nch = spack.tri_verts16.shape[1] // 32
    rows = sid0.long()[:, None, None] * nch + (head & ((1 << 18) - 1)).clamp(max=nch - 1)
    row_bytes = int(torch.unique(rows[gate]).numel()) * 2048
    cull_bytes = row_bytes + sum(a.numel() * a.element_size() for a in cull_args[1:]) + mask_k.numel() * 4
    cull_row = dict(
        name="cullmask_t", route="cuda", source="habitat_torch/csrc/cullmask.cu",
        replaces="habitat_tpu/ops/raycast_pallas.py:2051",
        max_abs_err=(mask_k[gate] - mask_p[gate]).abs().max().item(), mask_agree=mask_agree,
        ms=cuda_ms(lambda: rk.cullmask_t(*cull_args), 20),
        plain_ms=cuda_ms(lambda: rk.cullmask_t.plain(*cull_args), 3, warmup=1),
        **bound(cull_bytes, gated * 32 * FLOPS_PER_CULL_TRI), bytes=cull_bytes,
        distinct_row_bytes=row_bytes, gathered_row_bytes=gated * 2048,
        head_slots=head.shape[2], gated_slots_per_tile_mean=cntk.float().mean().item(),
        pass_fraction=mask_k[gate].mean().item(),
        survivors_per_tile_mean=lists["kernel"][1].float().mean().item(),
        # no single PyTorch call computes the test: the plain version is a chain of ~40 ops
        library_ms=None, design=rk.cullmask_design(),
    )
    if cull_row["design"]["spill_bytes"]:
        fail(f"cullmask_t spills: {cull_row['design']}")
    log(f"[kernel] cullmask_t on the scan reset's head ({head.shape[2]} slots, {cull_row['gated_slots_per_tile_mean']:.1f} "
        f"gated per tile): mask agreement {mask_agree:.6f}, lists equal on all {cntk.numel()} tiles; "
        f"{cull_row['ms']:.4f} ms (plain version {cull_row['plain_ms']:.3f} ms, no single PyTorch call); "
        f"{rate_text(cull_row)}; {cull_row['pass_fraction']:.3f} of gated triangles pass, "
        f"{cull_row['survivors_per_tile_mean']:.1f} chunklets per tile survive; design {cull_row['design']}")

    # the stem max pool's backward at the bench update's minibatch (T*N/2
    # images), in the layout the policy's stem hands it over
    backbone = policy.net.encoder.backbone
    with torch.no_grad():  # the encoder's front: NHWC observations seen as NCHW
        obs_view = torch.zeros(2, BENCH["height"], BENCH["width"], 4, device=dev).permute(0, 3, 1, 2)
        stem_out = F.relu(backbone.stem_norm(backbone.stem(obs_view.to(torch.bfloat16))))
    layout = torch.channels_last  # the one layout the kernel takes
    if not stem_out.is_contiguous(memory_format=layout):
        fail(f"the stem's output has strides {stem_out.stride()}, not channels-last")
    mb_images = BENCH["num_envs"] * BENCH["num_steps"] // TRAIN["num_mini_batch"]
    pool_shape = (mb_images, 32, BENCH["height"] // 2, BENCH["width"] // 2)
    gen = torch.Generator(device=dev).manual_seed(0)

    def pool_inputs(x):
        x = x.contiguous(memory_format=layout)
        y = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2).contiguous(memory_format=layout)
        dy = torch.randn(y.shape, generator=gen, device=dev).to(x.dtype).contiguous(memory_format=layout)
        return x, y, dy

    x_relu = torch.relu(torch.randn(pool_shape, generator=gen, device=dev)).to(torch.bfloat16)
    pool_args = pool_inputs(x_relu)
    del x_relu
    gx, pool_err = pool_check("ReLU", pool_args)
    # positive ties: ReLU noise on a grid of 1/4
    x_ties = (torch.relu(torch.randn(pool_shape, generator=gen, device=dev)) * 4).round().div(4).to(torch.bfloat16)
    tie_args = pool_inputs(x_ties)
    del x_ties
    pool_check("tie-rich", tie_args)
    # maxima credited per window: with dy = 1, gx counts the windows crediting each input
    ones = torch.ones_like(tie_args[2])
    maxima_per_window = pool.max_pool_3x3s2_bwd(tie_args[0], tie_args[1], ones).double().sum().item() / ones.numel()
    del tie_args, ones
    # float32 without ties (the 9 inputs of any window differ in (h % 3, w % 3),
    # so k * 9 + 3 * (h % 3) + w % 3 on a grid of 1/256 never repeats in a
    # window; plain normal noise ties a few hundred times at this size):
    # F.max_pool2d's own gradient credits the same inputs
    hh = torch.arange(pool_shape[2], device=dev)[:, None] % 3
    ww = torch.arange(pool_shape[3], device=dev) % 3
    k = torch.randint(-500, 500, pool_shape, generator=gen, device=dev)
    x32 = (k * 9 + hh * 3 + ww).float() / 256
    del k
    args32 = pool_inputs(x32)
    del x32
    gx32 = pool.max_pool_3x3s2_bwd(*args32)
    xp = F.pad(args32[0], (0, 1, 0, 1), value=float("-inf")).requires_grad_(True)
    (g_lib,) = torch.autograd.grad(F.max_pool2d(xp, 3, 2), xp, args32[2])
    lib32_err = (gx32 - g_lib[:, :, :-1, :-1]).abs().max().item()
    # equal, up to the order of a float32 sum where two windows credit one input
    if lib32_err > 1e-6 * gx32.abs().max().item():
        fail(f"max_pool_3x3s2_bwd differs from F.max_pool2d's gradient on a tie-free float32 input: {lib32_err}")
    del gx32, g_lib, xp, args32
    # timed: the kernel, its plain version, and one PyTorch call computing a
    # max-pool backward at the same shape (autograd through F.max_pool2d on
    # the -inf-padded input; it credits one tied input, not all)
    x_lib = F.pad(pool_args[0], (0, 1, 0, 1), value=float("-inf")).requires_grad_(True)
    y_lib = F.max_pool2d(x_lib, 3, 2)
    pool_bytes = sum(a.numel() * a.element_size() for a in pool_args) + gx.numel() * gx.element_size()
    pool_row = dict(
        name="max_pool_3x3s2_bwd", route="cuda", source="habitat_torch/csrc/maxpool_bwd.cu",
        replaces="habitat_tpu/ops/pool.py:123", max_abs_err=pool_err,
        ms=cuda_ms(lambda: pool.max_pool_3x3s2_bwd(*pool_args), 20),
        plain_ms=cuda_ms(lambda: pool.max_pool_3x3s2_bwd.plain(*pool_args), 3, warmup=1),
        **bound(pool_bytes, FLOPS_PER_POOL_ELEMENT * gx.numel()), bytes=pool_bytes,
        library_ms=cuda_ms(lambda: torch.autograd.grad(y_lib, x_lib, pool_args[2], retain_graph=True), 10),
        library_note="autograd.grad through F.max_pool2d on the padded input; credits one tied input",
        shape=list(pool_shape), dtype="bfloat16", layout=str(layout),
        tie_rich_maxima_per_window=maxima_per_window, f32_vs_library_max_abs_err=lib32_err,
        design=pool.maxpool_bwd_design(torch.bfloat16), design_f32=pool.maxpool_bwd_design(torch.float32),
    )
    for d in (pool_row["design"], pool_row["design_f32"]):
        if d["spill_bytes"]:
            fail(f"max_pool_3x3s2_bwd spills: {d}")
    del x_lib, y_lib, gx, pool_args
    torch.cuda.empty_cache()
    log(f"[kernel] max_pool_3x3s2_bwd at {pool_shape} bf16 ({layout}): bit-equal to its plain version on the ReLU "
        f"and the tie-rich input ({maxima_per_window:.3f} maxima credited per window); against "
        f"F.max_pool2d's gradient on tie-free float32 max |d| {lib32_err:.3g}; {pool_row['ms']:.4f} ms (plain "
        f"{pool_row['plain_ms']:.3f} ms, autograd through F.max_pool2d {pool_row['library_ms']:.3f} ms); "
        f"{rate_text(pool_row)}; design bf16 {pool_row['design']}, float32 {pool_row['design_f32']}")

    # the general route: the index kernel on the panoramic bench reset and on
    # the mid-size scene's fisheye reset, every chunk of min(128, T) tested
    general_src = "habitat_torch/csrc/raycast_general.cu"
    pano_hw = dict(height=PANO["height"], width=PANO["width"])
    R_pano = PANO["height"] * PANO["width"]
    kernel, args, kwargs, _ = reset_render_call(pano_env, pano_hw, projection="equirect")
    if kernel is not rk.raycast_index_t or kwargs["ray_tile"] != 2048:
        fail("the panoramic bench render should take the index kernel on 2048-ray tiles")
    index_row = ring_row(
        "raycast_index_t", kernel, args, kwargs, BENCH["num_envs"] * R_pano * args[0].shape[3],
        rk.index_design(128), PANO["width"], reps=20, plain_reps=1, source=general_src, flops_per_ray=0,
    )
    index_row["replaces"] = "habitat_tpu/ops/raycast_pallas.py:327"
    kernel, args, kwargs, _ = reset_render_call(mid_env, projection="fisheye")
    if kernel is not rk.raycast_index_t or args[0].shape[3] != 4352:
        fail("the mid-size fisheye render should take the index kernel over 4352 triangles")
    mid_fe = ring_row(
        "raycast_index_t", kernel, args, kwargs, MID["num_envs"] * R * args[0].shape[3],
        index_row["design"], BENCH["width"], reps=10, plain_reps=1, source=general_src, flops_per_ray=0,
    )
    index_row["mid_fisheye_n16_128x128"] = {k: mid_fe[k] for k in (
        "max_abs_err", "hit_agree", "idx_agree", "rays_differing", "ms", "plain_ms", "bound_ms", "bound_by",
        "bound_old_rule_ms", "inside_pairs", "hit_fraction")}
    for tag, r in (("panoramic bench reset (N=256, 128x256 equirect, 128 tris)", index_row),
                   ("mid-size fisheye reset (N=16, 128x128, 4352 tris)", mid_fe)):
        log(f"[kernel] raycast_index_t on the {tag}: hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} "
            f"|dt| {r['max_abs_err']:.3g}, {r['rays_differing']} rays differ from the plain version; {r['ms']:.4f} "
            f"ms (plain {r['plain_ms']:.3f} ms), hit fraction {r['hit_fraction']:.4f}; {ring_text(r)}")

    # the culled kernel on the scan env's equirect reset: each raster-order
    # 1024-ray tile's K nearest occlusion-bounded chunks of the pack's 256
    ps0, _ = pano_scan_env.reset_fn()
    ps_sid, ps_cam = pano_scan_env._make_ctx(ps0).sid.to(torch.int32), (ps0.pos + cam_offset).float()
    ps_pose = (spack, ps_sid, ps_cam, ps0.yaw, ps0.pitch)
    kernel, args, kwargs, ps_dirs = rc.closest_hit_call(*ps_pose, **pano_hw, projection="equirect")
    C_scan = spack.tri_mat.shape[3] // spack.chunk_bounds.shape[1]
    if kernel is not rk.raycast_culled_t or kwargs["tri_chunk"] != C_scan or kwargs["ray_tile"] != 1024:
        fail(f"the scan env's equirect render should take the culled kernel on chunks of {C_scan}")
    culled_row, (t7, a7) = compare_culled(kernel, args, kwargs, source=general_src)
    culled_args = args
    culled_row["replaces"] = "habitat_tpu/ops/raycast_pallas.py:1614"
    culled_row["design"] = kernel_design("raycast_culled_t", rk.culled_design(C_scan, args[2].shape[2]), 1024,
                                         rk.RING_STAGES, tile_width=PANO["width"])
    log(f"[kernel] raycast_culled_t on the scan equirect reset (N={PANO_SCAN['num_envs']}, 128x256, "
        f"K={culled_row['list_slots']} chunks of {C_scan} per 1024-ray tile; the plain version on all envs): "
        f"hit {culled_row['hit_agree']:.6f}, attributes equal on {culled_row['attr_agree']:.6f} of common hits, "
        f"|dt| {culled_row['max_abs_err']:.3g} where they are; {culled_row['ms']:.3f} ms (plain "
        f"{culled_row['plain_ms']:.0f} ms, bound {culled_row['bound_ms']:.3f} ms by {culled_row['bound_by']}), "
        f"hit fraction {culled_row['hit_fraction']:.4f}, {culled_row['ray_tri_tests'] / culled_row['ms'] / 1e-3:.4g} "
        f"tests/s, {culled_row['inside_pairs']} inside pairs; {design_text(culled_row['design'])}")

    def ray_batch_phase(t7, a7):
        """#8-#10 against their plain versions and against #3, #7 and #1 on
        the same inputs, then the ray-batch path; returns their rows (the
        tensors made here die with the call)."""
        # the ray-batch index kernel (#8) on the bench reset's rays: row-major
        # features, the split margin; against its plain version and, on the same
        # rays, against the index kernel #3 (the margins differ on boundaries only)
        st_b, _ = env.reset_fn()
        sid_b, cam_b = env._make_ctx(st_b).sid.to(torch.int32), (st_b.pos + cam_offset).float()
        dirs_b = rc.world_rays(st_b.yaw, st_b.pitch, 90.0, **hw)
        orig_b = cam_b[:, None, :].expand(-1, R, -1)
        feat_b = rc.ray_features(orig_b, dirs_b)
        rb_args = (env.pack.tri_mat, sid_b, feat_b)
        batch_row = ring_row(
            "raycast_index", rk.raycast_index, rb_args, dict(ray_tile=2048), BENCH["num_envs"] * R * env.pack.tri_mat.shape[3],
            rk.index_design(128, row_major=True), BENCH["width"], reps=20, plain_reps=1, source=general_src,
            flops_per_ray=0,
        )
        batch_row["replaces"] = "habitat_tpu/ops/raycast_pallas.py:151"
        t8, i8 = rk.raycast_index(*rb_args, ray_tile=2048)
        t3, i3 = rk.raycast_index_t(env.pack.tri_mat, sid_b, rc.ray_features_t(orig_b, dirs_b, 2048), ray_tile=2048)
        batch_row["vs_index_t"] = dict(zip(("hit_agree", "idx_agree", "max_abs_err"),
                                          agreement("raycast_index against raycast_index_t", (t8, i8), (t3, i3))))
        batch_row["vs_index_t"]["rays_differing"] = int(((t8 != t3) | (i8 != i3)).sum().item())
        log(f"[kernel] raycast_index on the bench reset's rays (N=256, 128x128, T={env.pack.tri_mat.shape[3]}): hit "
            f"{batch_row['hit_agree']:.6f} idx {batch_row['idx_agree']:.6f} |dt| {batch_row['max_abs_err']:.3g}, "
            f"{batch_row['rays_differing']} rays differ from the plain version; {batch_row['ms']:.4f} ms (plain "
            f"{batch_row['plain_ms']:.3f} ms); against raycast_index_t on the same rays: hit "
            f"{batch_row['vs_index_t']['hit_agree']:.6f}, idx {batch_row['vs_index_t']['idx_agree']:.6f} on common hits, "
            f"{batch_row['vs_index_t']['rays_differing']} rays differ; {ring_text(batch_row)}")
        del t3, i3

        # the v3 culled kernel (#9) on #7's inputs: its 160 ids of 256-triangle
        # chunks as 320 ids of 128 (c -> 2c, 2c + 1) test the same triangles in
        # the same order, from row-major features and attribute rows
        ids7 = culled_args[2]
        ids128 = (ids7[..., None] * 2 + torch.arange(2, dtype=torch.int32, device=dev)).reshape(*ids7.shape[:2], -1)
        feat9 = rc.ray_features(ps_cam[:, None, :].expand(-1, ps_dirs.shape[1], -1), ps_dirs)
        c9_args = (spack.tri_mat, spack.tri_attr, ids128.contiguous(), ps_sid, None, None)
        c9_kwargs = dict(ray_tile=1024, tri_chunk=128, features=feat9)
        c9_row, (t9, a9) = compare_culled(rk.raycast_culled, c9_args, c9_kwargs, source=general_src, attr_dim=2)
        c9_row["replaces"] = "habitat_tpu/ops/raycast_pallas.py:1764"
        a7r = a7.transpose(1, 2)
        hit7 = a7r[..., 7] > 0.5
        same7 = (t9 == t7) & (a9 == a7r).all(-1)
        c9_row["vs_culled_t"] = dict(hit_agree=share((a9[..., 7] > 0.5) == hit7), rays_differing=int((~same7).sum().item()))
        if c9_row["vs_culled_t"]["rays_differing"]:  # the same triangles in the same order: the same bits
            fail(f"raycast_culled on 128-triangle ids disagrees with raycast_culled_t: {c9_row['vs_culled_t']}")
        c9_row["design"] = kernel_design("raycast_culled", rk.culled_design(128, ids128.shape[2], row_major=True),
                                         1024, rk.RING_STAGES, tile_width=PANO["width"])
        log(f"[kernel] raycast_culled on the scan equirect reset (N={PANO_SCAN['num_envs']}, 128x256, K={ids128.shape[2]} "
            f"chunks of 128 per 1024-ray tile): hit {c9_row['hit_agree']:.6f}, attributes equal on "
            f"{c9_row['attr_agree']:.6f} of common hits, |dt| {c9_row['max_abs_err']:.3g}; {c9_row['ms']:.3f} ms (plain "
            f"{c9_row['plain_ms']:.0f} ms, bound {c9_row['bound_ms']:.3f} ms by {c9_row['bound_by']}); against "
            f"raycast_culled_t on the unsplit ids: {c9_row['vs_culled_t']['rays_differing']} of {t9.numel()} rays differ in "
            f"t or an attribute; {design_text(c9_row['design'])}")
        del a7r, t9, a9

        # the tile-cull kernel (#10) on the bench reset, with the arguments #1
        # received there and attr16_table(pack)
        gm32, sid1, ids1, cnt1, d_t1, Bt1 = fused_sel_args
        a16 = rk.attr16_table(env.pack.tri_attr, env.pack.tri_v0, tri_chunk=fused_sel_kwargs["tri_chunk"])
        tc_args = (gm32, a16, ids1, cnt1, sid1, d_t1, Bt1)
        tc_row, (t10, a10) = compare_tilecull(
            rk.raycast_tilecull_t, tc_args, fused_sel_kwargs, int(cnt1.sum().item()) * 32 * fused_sel_kwargs["ray_tile"])
        t1, i1 = rk.raycast_fused_sel_t(*fused_sel_args, **fused_sel_kwargs)
        hit10 = (a10[:, :, 11] > 0.5).reshape(t10.shape)
        gid10 = a10[:, :, 6].reshape(t10.shape)
        both = hit10 & (i1 >= 0)
        tc_row["vs_fused_sel_t"] = dict(hit_agree=share(hit10 == (i1 >= 0)), gid_agree=share(gid10[both] == i1[both].float()))
        # the pinhole route's own plane-exact t from #1's winner
        d_aug1 = rc.pinhole_constants(90.0, BENCH["height"], BENCH["width"], dev)[0]
        t_pl1, _, _ = rc.plane_exact_t(env.pack, sid1, fused_sel_B, t1, i1, d_aug1)
        same1 = both & (gid10 == i1.float())
        tc_row["vs_fused_sel_t"]["plane_exact_max_abs_err"] = (t10[same1] - t_pl1[same1]).abs().max().item()
        # one loop: #1's winner on every ray
        tc_row["vs_fused_sel_t"]["gid_rays_differing"] = int((torch.where(hit10, gid10, -1.0) != i1.float()).sum().item())
        if (tc_row["vs_fused_sel_t"]["hit_agree"] < 0.9999 or tc_row["vs_fused_sel_t"]["gid_agree"] < 0.999
                or tc_row["vs_fused_sel_t"]["plane_exact_max_abs_err"] >= 5e-3
                or tc_row["vs_fused_sel_t"]["gid_rays_differing"]):
            fail(f"raycast_tilecull_t against raycast_fused_sel_t and the pinhole route's plane-exact t: "
                 f"{tc_row['vs_fused_sel_t']}")
        tc_row["design"] = kernel_design("raycast_tilecull_t", rk.tilecull_design(32), rk.RING_BLOCK_RAYS,
                                         rk.RING_STAGES, tile_width=BENCH["width"])
        if tc_row["design"]["rays_per_thread"] != 4:
            fail(f"raycast_tilecull_t: {tc_row['design']['rays_per_thread']} rays per thread, not 4")
        log(f"[kernel] raycast_tilecull_t on the bench reset (N=256, 128x128, {tc_row['survivor_chunks_mean']:.2f} "
            f"survivor chunks of 32 per 2048-ray tile): hit {tc_row['hit_agree']:.6f}, gid {tc_row['idx_agree']:.6f} of "
            f"common hits, 16 rows within 1e-5 on {tc_row['rows_agree']:.6f} of rays with the same winner (max |d| "
            f"{tc_row['max_abs_err']:.3g}, row 12 {tc_row['miss_shade']} on every miss), {tc_row['rays_differing']} rays "
            f"differ from the plain version in t or a row; {tc_row['ms']:.4f} ms (plain {tc_row['plain_ms']:.3f} ms); "
            f"against raycast_fused_sel_t: hit {tc_row['vs_fused_sel_t']['hit_agree']:.6f}, gid = idx on "
            f"{tc_row['vs_fused_sel_t']['gid_agree']:.6f} of hits ({tc_row['vs_fused_sel_t']['gid_rays_differing']} rays "
            f"differ), |t - plane-exact t| <= {tc_row['vs_fused_sel_t']['plane_exact_max_abs_err']:.3g} m; "
            f"{ring_text(tc_row)}")
        del t10, a10, t1, i1

        # the ray-batch path: each entry point once on the inputs above
        zero_counts()
        t_rb, attrs_rb = rk.raycast_batch(env.pack.tri_mat, env.pack.tri_attr, sid_b, orig_b, dirs_b)
        t_rc, attrs_rc = rk.raycast_culled(*c9_args, **c9_kwargs)
        t_rt, attrs_rt = rk.raycast_tilecull_t(*tc_args, **fused_sel_kwargs)
        torch.cuda.synchronize()
        batch_launches = path_counts("ray-batch path", raycast_index=1, raycast_culled=1, raycast_tilecull_t=1)
        for name, t_, a_, shape in (("raycast_batch", t_rb, attrs_rb, (BENCH["num_envs"], R, 8)),
                                    ("raycast_culled", t_rc, attrs_rc, (PANO_SCAN["num_envs"], R_pano, 8)),
                                    ("raycast_tilecull_t", t_rt, attrs_rt, (BENCH["num_envs"], R // 2048, 16, 2048))):
            if a_.shape != shape or not (torch.isfinite(t_).all() and torch.isfinite(a_).all()):
                fail(f"{name}: bad output {tuple(a_.shape)}")
        # the batch's attributes are the index kernel's winners' rows
        if not torch.equal(attrs_rb, env.pack.tri_attr[sid_b.long()[:, None], i8.clamp(min=0).long()] * (i8 >= 0)[..., None]):
            fail("raycast_batch's attributes are not its winners' rows")
        log(f"[raybatch] raycast_batch, raycast_culled and raycast_tilecull_t once each: launches {batch_launches}; hit "
            f"shares {share(attrs_rb[..., 7] > 0.5):.4f}, {share(attrs_rc[..., 7] > 0.5):.4f}, "
            f"{share(attrs_rt[:, :, 11] > 0.5):.4f}")
        batch_row["launches"] = batch_launches["raycast_index"]
        c9_row["launches"] = batch_launches["raycast_culled"]
        tc_row["launches"] = batch_launches["raycast_tilecull_t"]
        return batch_row, c9_row, tc_row


    batch_row, c9_row, tc_row = ray_batch_phase(t7, a7)
    del t7, a7, culled_args, ps_dirs
    torch.cuda.empty_cache()

    kernels = [sel, every, exact_row, stream_row, cull_row, pool_row, index_row, culled_row, batch_row, c9_row,
               tc_row]
    for tag, r in (("bench reset", sel), ("mid-size reset", every), ("synthetic 8192 tris", synth)):
        log(f"[kernel] {r['name']} on the {tag}: hit {r['hit_agree']:.6f} idx {r['idx_agree']:.6f} "
            f"|dt| {r['max_abs_err']:.3g}, {r['rays_differing']} rays differ from the plain version; {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.3f} ms); {ring_text(r)}")

    # ---- 3. main path ----------------------------------------------------
    T_steps = BENCH["num_steps"]
    frames_shape = (T_steps, BENCH["num_envs"], BENCH["height"], BENCH["width"], 1)
    learner = PPOLearner(env, policy, PPOConfig(num_steps=T_steps))
    zero_counts()
    rs = learner.init(seed=0)
    rs, batch, last_value, _, _ = learner.collect_rollout(rs)  # warm-up
    walls = []
    for _ in range(ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, batch, last_value, _, stats = learner.collect_rollout(rs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # reset render + one per step
    main_launches = path_counts("main path", raycast_fused_sel_t=1 + (1 + ROLLOUTS) * T_steps)
    for name, x in (("values", batch.values), ("rewards", batch.rewards), ("log_probs", batch.log_probs),
                    ("last_value", last_value)):
        if not torch.isfinite(x).all():
            fail(f"non-finite {name}")
    with torch.no_grad():
        logits, _, _ = policy(rs.obs, rs.hidden, rs.prev_action, rs.not_done)
    if not torch.isfinite(logits).all() or logits.shape != (BENCH["num_envs"], 4):
        fail("bad logits")
    depth = batch.obs["depth"]
    if depth.shape != frames_shape or not torch.isfinite(depth.float()).all():
        fail("bad depth frames")
    steps = BENCH["num_envs"] * T_steps
    sps = sorted(steps / w for w in walls)
    median_wall = sorted(walls)[ROLLOUTS // 2]

    # per-layer times on the rollout's last state
    state = rs.env_state
    ctx = env._make_ctx(state)
    cam = state.pos + torch.tensor([0.0, 1.25, 0.0], device=dev)
    render_ms = cuda_ms(lambda: rc.render_batch(env.pack, ctx.sid, cam, state.yaw, state.pitch, **hw), 10)
    with torch.no_grad():
        policy_ms = cuda_ms(lambda: policy(rs.obs, rs.hidden, rs.prev_action, rs.not_done), 10)
    actions = torch.ones(BENCH["num_envs"], dtype=torch.int32, device=dev)
    step_ms = cuda_ms(lambda: env.step_fn(state, actions), 10)
    log(f"[main] {gpu}: env-steps/s median {sps[ROLLOUTS // 2]:.1f} over {ROLLOUTS} rollouts "
        f"(min {sps[0]:.1f}, max {sps[-1]:.1f}; walls ms {[round(w * 1e3, 1) for w in walls]} "
        f"for {BENCH['num_envs']}x{T_steps}), render {render_ms:.3f} ms/step, policy {policy_ms:.3f} ms/step, "
        f"env step incl. render {step_ms:.3f} ms/step, episodes done {int(stats['done_count'].item())}, "
        f"launches {main_launches}")

    def profiled(tag, what, fn, wall, top=15, name=None):
        """Run fn() once under torch.profiler: device kernel time against
        the unprofiled wall ``wall`` (kernels run on one stream), launches
        and the top kernels, and the time and share of the kernels whose
        name holds ``name``. Returns fn's result."""
        out, device_ms, launches, dev_kernels = device_time_and_launches(fn)
        log(f"[{tag}] one {what}: device kernel time {device_ms:.1f} ms, idle share "
            f"{1 - device_ms / (wall * 1e3):.3f} of the median unprofiled wall, {launches} kernel launches")
        for e in dev_kernels[:top]:
            log(f"[{tag}]   {device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
        if name:
            named = [e for e in dev_kernels if name in e.key]
            named_ms = sum(device_us(e) for e in named) / 1e3
            log(f"[{tag}] {name}: {named_ms:.3f} ms in {sum(e.count for e in named)} launches, "
                f"{named_ms / device_ms:.4f} of the device kernel time")
        return out

    rs = profiled("profile", "rollout", lambda: learner.collect_rollout(rs)[0], median_wall)

    # mid-size-scene route: every-chunk kernel
    mid_learner = PPOLearner(mid_env, policy, PPOConfig(num_steps=MID["num_steps"]))
    zero_counts()
    mrs = mid_learner.init(seed=1)
    mrs, mbatch, mlast, _, _ = mid_learner.collect_rollout(mrs)
    torch.cuda.synchronize()
    mid_launches = path_counts("mid-size route", raycast_fused_t=1 + MID["num_steps"])
    if not (torch.isfinite(mbatch.values).all() and torch.isfinite(mlast).all()):
        fail("non-finite values on the mid-size route")
    log(f"[mid] launches {mid_launches}")
    sel["launches"] = main_launches["raycast_fused_sel_t"]
    every["launches"] = mid_launches["raycast_fused_t"]

    # ---- scan path: the same rollout on the 859,290-triangle LOD scene -----
    scan_learner = PPOLearner(scan_env, policy, PPOConfig(num_steps=T_steps))
    zero_counts()
    srs = scan_learner.init(seed=2)
    srs, sbatch, slast, _, _ = scan_learner.collect_rollout(srs)  # warm-up
    swalls = []
    for _ in range(SCAN_ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srs, sbatch, slast, _, sstats = scan_learner.collect_rollout(srs)
        torch.cuda.synchronize()
        swalls.append(time.perf_counter() - t0)
    scan_renders = 1 + (1 + SCAN_ROLLOUTS) * T_steps  # reset render + one per step
    scan_launches = path_counts("scan path", raycast_exactsel_t=scan_renders, cullmask_t=scan_renders)
    sdepth = sbatch.obs["depth"]
    if sdepth.shape != frames_shape or not torch.isfinite(sdepth.float()).all():
        fail("bad depth frames on the scan path")
    if (sdepth.float() < 0.999).float().mean() < 0.5:
        fail("the scan path's depth frames see too little geometry")
    for name, x in (("values", sbatch.values), ("rewards", sbatch.rewards), ("last_value", slast)):
        if not torch.isfinite(x).all():
            fail(f"non-finite {name} on the scan path")
    ssps = sorted(steps / w for w in swalls)
    smedian_wall = sorted(swalls)[SCAN_ROLLOUTS // 2]
    sstate = srs.env_state
    sctx = scan_env._make_ctx(sstate)
    scam = sstate.pos + cam_offset
    pose = (spack, sctx.sid, scam, sstate.yaw, sstate.pitch)
    ssplit, (kernel, args, kwargs) = render_split(pose, hw, 5)
    with torch.no_grad():
        spolicy_ms = cuda_ms(lambda: policy(srs.obs, srs.hidden, srs.prev_action, srs.not_done), 5)
    sstep_ms = cuda_ms(lambda: scan_env.step_fn(sstate, actions), 5)
    log(f"[scan] {gpu}: env-steps/s median {ssps[SCAN_ROLLOUTS // 2]:.1f} over {SCAN_ROLLOUTS} rollouts "
        f"(min {ssps[0]:.1f}, max {ssps[-1]:.1f}; walls ms {[round(w * 1e3, 1) for w in swalls]} "
        f"for {BENCH['num_envs']}x{T_steps}); per step: {split_text(ssplit)}; env step incl. render {sstep_ms:.3f} ms, policy "
        f"{spolicy_ms:.3f} ms; {args[3].float().mean().item():.1f} chunklets listed per tile; episodes done "
        f"{int(sstats['done_count'].item())}, launches {scan_launches}")
    srs = profiled("scan-profile", "rollout", lambda: scan_learner.collect_rollout(srs)[0], smedian_wall)
    exact_row["launches"] = scan_launches["raycast_exactsel_t"]
    cull_row["launches"] = scan_launches["cullmask_t"]

    # one reset render through the chunk stream
    reset_pose = (spack, sid0, cam0, st0.yaw, st0.pitch)
    frames = rc.render_batch(*reset_pose, **hw)
    zero_counts()
    frames_s = rc.render_batch(*reset_pose, backend="stream", **hw)
    torch.cuda.synchronize()
    stream_row["launches"] = path_counts("stream render", raycast_stream_t=1)["raycast_stream_t"]
    hit_d, hit_s = frames["depth"] < 0.999, frames_s["depth"] < 0.999
    stream_hit_agree = share(hit_d == hit_s)
    both = hit_d & hit_s
    log(f"[stream] reset render with backend=stream: hit/miss equal on {stream_hit_agree:.6f} of pixels, "
        f"depth within 1e-3 on {share((frames['depth'] - frames_s['depth']).abs()[both] < 1e-3):.6f} "
        f"of common hits")
    if stream_hit_agree < 0.999:
        fail(f"the stream route's hit/miss differs from the default route's on {1 - stream_hit_agree} of pixels")
    # the default route's frames (cull mask from the kernel) against a render
    # whose cull mask comes from the plain version
    zero_counts()
    with with_plain_mask:
        frames_p = rc.render_batch(*reset_pose, **hw)
    torch.cuda.synchronize()
    path_counts("render with the plain cull mask", raycast_exactsel_t=1)
    for k in frames:
        if not torch.equal(frames[k], frames_p[k]):
            fail(f"the cull-mask kernel changes the {k} frames")
    log("[cull] reset render: rgb, depth and semantic from the cull-mask kernel equal those from its plain version")

    # ---- 5. exactness: the deployed scan route against the all-chunks oracle -----
    n_val, eh = 2, 64
    vrng = np.random.default_rng(0)
    vpos = np.stack([scan_scene.sample_navigable_point(vrng) for _ in range(n_val)])
    vpos[:, 1] = scan_scene.floor_y + 1.2
    vpos = torch.as_tensor(vpos, dtype=torch.float32, device=dev)
    vyaw = torch.as_tensor(vrng.uniform(0, 2 * np.pi, n_val), dtype=torch.float32, device=dev)
    vpitch = torch.zeros(n_val, device=dev)
    vsid = torch.zeros(n_val, dtype=torch.int32, device=dev)
    vdirs = rc.world_rays(vyaw, vpitch, 90.0, eh, eh)  # raster order

    def plane_exact(t, idx):
        t, idx = rc.from_blocks(t, eh, eh), rc.from_blocks(idx, eh, eh)
        hit = idx >= 0
        safe = idx.clamp(min=0).long()
        nrm = spack.tri_attr[0, safe, 0:3]
        nd = (nrm * vdirs).sum(-1)
        num = (nrm * (spack.tri_v0[0, safe] - vpos[:, None, :])).sum(-1)
        ok = hit & (nd.abs() > 1e-6)
        return torch.where(ok, num / torch.where(ok, nd, torch.ones_like(nd)), 1e6), hit

    kernel, args, kwargs, _ = rc.closest_hit_call(spack, vsid, vpos, vyaw, vpitch, height=eh, width=eh)
    if kernel is not rk.raycast_exactsel_t:
        fail("the exactness guard should run the deployed chunklet stream")
    t_k, hit_k = plane_exact(*kernel(*args, **kwargs))
    d_t_v, Bt_v = args[4], args[5]
    # oracle: every chunk whose LOD band holds the tile's apex, nearest first
    cb = spack.chunk_bounds[vsid.long()]
    NC = cb.shape[1]
    dist_c = torch.linalg.vector_norm(cb[:, None, :, :3] - vpos[:, None, None, :], dim=-1)
    dist_c = dist_c.expand(n_val, d_t_v.shape[0], NC)
    valid_c = (cb[..., 3] > 0)[:, None, :] & rc._lod_band_ok(cb, dist_c)
    score_c = torch.where(valid_c, (dist_c - cb[..., 3][:, None]).clamp(min=0.0), 1e9)
    ids_all, cnt_all = rc._pack_nearest_first(*torch.topk(-score_c, NC, dim=-1))
    C_big = spack.tri_mat.shape[3] // NC
    t_o, hit_o = plane_exact(*rk.raycast_stream_t(
        rc.group_tri_mat(spack.tri_mat, C_big).contiguous(), vsid, ids_all.contiguous(), cnt_all, d_t_v, Bt_v,
        ray_tile=1024, tri_chunk=C_big,
    ))
    both = hit_o & hit_k
    hitmatch = share(hit_o == hit_k)
    t_agree = share((t_o[both] - t_k[both]).abs() < 5e-3)
    log(f"[exactness] {eh}x{eh}, {n_val} poses: scan_cull_hitmatch {hitmatch:.6f}, scan_cull_t_agree_5mm {t_agree:.6f} "
        f"(hit fraction {hit_k.float().mean().item():.4f}; oracle {cnt_all.float().mean().item():.1f} band-valid chunks "
        f"of {NC} per tile, deployed {args[3].float().mean().item():.1f} chunklets per tile)")
    if hitmatch < 0.9999 or t_agree < 0.9999:
        fail(f"the scan route disagrees with the all-chunks oracle: hitmatch {hitmatch}, t_agree_5mm {t_agree}")

    # ---- 6. train: rollout + PPO update at the bench shape, then the scan scene ----
    plain_on_card = []

    def watch(fn):
        def run(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                plain_on_card.append(fn.__name__)
            return fn(*args, **kwargs)
        return run

    # every plain version, by the names its wrapper calls it
    plain_watch = [
        mock.patch.object(pool, "max_pool_3x3s2_bwd_plain", watch(pool.max_pool_3x3s2_bwd_plain)),
        mock.patch.object(rk, "raycast_fused_sel_t_plain", watch(rk.raycast_fused_sel_t_plain)),
        mock.patch.object(rk, "raycast_fused_t_plain", watch(rk.raycast_fused_t_plain)),
        mock.patch.object(rk, "cull_mask_torch", watch(rk.cull_mask_torch)),
        mock.patch.object(rk.raycast_exactsel_t, "plain", watch(rk.raycast_exactsel_t.plain)),
        mock.patch.object(rk.raycast_stream_t, "plain", watch(rk.raycast_stream_t.plain)),
        mock.patch.object(rk, "raycast_index_t_plain", watch(rk.raycast_index_t_plain)),
        mock.patch.object(rk, "raycast_culled_t_plain", watch(rk.raycast_culled_t_plain)),
        mock.patch.object(rk, "raycast_index_plain", watch(rk.raycast_index_plain)),
        mock.patch.object(rk, "raycast_culled_plain", watch(rk.raycast_culled_plain)),
        mock.patch.object(rk, "raycast_tilecull_t_plain", watch(rk.raycast_tilecull_t_plain)),
    ]

    def train_path(tag, lrn, seed, steps):
        """A warm-up and ``steps`` timed train steps; returns (rollout
        state, train env-steps/s sorted, per-step rollout and update ms,
        the last metrics, peak bytes)."""
        split = {"rollout": [], "update": []}

        def timed(name, fn):
            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                split[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        lrn.collect_rollout = timed("rollout", lrn.collect_rollout)
        lrn.update = timed("update", lrn.update)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        for p in plain_watch:
            p.start()
        state = lrn.init(seed=seed)
        walls = []
        for i in range(1 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = lrn.train_step(state)
            metrics = {k: v.item() for k, v in metrics.items()}
            if i:
                walls.append(time.perf_counter() - t0)
            if not all(np.isfinite(v) for v in metrics.values()):
                fail(f"{tag}: non-finite metrics {metrics}")
        torch.cuda.synchronize()
        for p in plain_watch:
            p.stop()
        del lrn.collect_rollout, lrn.update
        if plain_on_card:
            fail(f"{tag}: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
        rates = sorted(BENCH["num_envs"] * TRAIN["num_steps"] / w for w in walls)
        return state, rates, split, metrics, torch.cuda.max_memory_allocated()

    train_learner = PPOLearner(env, policy, PPOConfig(**TRAIN))
    trs, rates, split, metrics, peak = train_path("train", train_learner, 3, TRAIN_STEPS)
    renders = 1 + (1 + TRAIN_STEPS) * T_steps
    updates = (1 + TRAIN_STEPS) * TRAIN["ppo_epoch"] * TRAIN["num_mini_batch"]
    train_launches = path_counts("train path", raycast_fused_sel_t=renders, max_pool_3x3s2_bwd=updates)
    pool_row["launches"] = train_launches["max_pool_3x3s2_bwd"]
    train_median = rates[TRAIN_STEPS // 2]
    log(f"[train] {gpu}: train env-steps/s median {train_median:.1f} over {TRAIN_STEPS} train steps (min {rates[0]:.1f}, "
        f"max {rates[-1]:.1f}); per step rollout ms {[round(x, 1) for x in split['rollout'][1:]]}, update ms "
        f"{[round(x, 1) for x in split['update'][1:]]} (warm-up {split['rollout'][0]:.1f} + {split['update'][0]:.1f}); "
        f"peak memory {peak / 2**30:.2f} GiB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k.startswith("losses/") or k == "grad_norm")
        + f"; launches {train_launches}")
    # one update under the profiler, on a fresh rollout's batch
    trs, tbatch, tlast, th0, _ = train_learner.collect_rollout(trs)
    update_wall = sorted(split["update"][1:])[TRAIN_STEPS // 2] / 1e3
    # and whether the gradient reaches the pool's backward in x's layout, or
    # needs a copy before the kernel
    dy_layouts = []
    pool_backward = pool._MaxPool3x3s2.backward

    def backward_seen(ctx, dy):
        dy_layouts.append(dy.is_contiguous(memory_format=torch.channels_last))
        return pool_backward(ctx, dy)

    with mock.patch.object(pool._MaxPool3x3s2, "backward", staticmethod(backward_seen)):
        profiled("train-profile", "update", lambda: train_learner.update(trs.generator, tbatch, tlast, th0),
                 update_wall, name="maxpool_bwd")
    log(f"[train-profile] the pool's backward got dy channels-last in {sum(dy_layouts)} of {len(dy_layouts)} calls "
        f"({len(dy_layouts) - sum(dy_layouts)} copies before the kernel)")
    del tbatch, tlast, th0, trs

    scan_train = PPOLearner(scan_env, policy, PPOConfig(**TRAIN))
    _, srates, ssplit, smetrics, speak = train_path("scan-train", scan_train, 4, SCAN_TRAIN_STEPS)
    renders = 1 + (1 + SCAN_TRAIN_STEPS) * T_steps
    updates = (1 + SCAN_TRAIN_STEPS) * TRAIN["ppo_epoch"] * TRAIN["num_mini_batch"]
    scan_train_launches = path_counts(
        "scan train path", raycast_exactsel_t=renders, cullmask_t=renders, max_pool_3x3s2_bwd=updates)
    log(f"[scan-train] {gpu}: train env-steps/s {[round(r, 1) for r in srates]} over {SCAN_TRAIN_STEPS} train steps; "
        f"per step rollout ms {[round(x, 1) for x in ssplit['rollout'][1:]]}, update ms "
        f"{[round(x, 1) for x in ssplit['update'][1:]]}; peak memory {speak / 2**30:.2f} GiB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in smetrics.items() if k.startswith("losses/"))
        + f"; launches {scan_train_launches}")

    # ---- 7. card vs CPU on a small input --------------------------------
    small = dict(num_envs=8, precomputed_fields=fields, max_episode_steps=500, sensor_specs=sensors)
    env_c = make_nav_env(scenes, episodes, device="cpu", **small)
    env_g = make_nav_env(scenes, episodes, **small)
    sc, oc = env_c.reset_fn()
    sg, og = env_g.reset_fn()
    acts = torch.tensor([[1, 1, 2, 3, 1, 1, 2, 1], [1, 2, 1, 1, 3, 1, 1, 0], [1, 1, 1, 2, 1, 3, 1, 1]], dtype=torch.int32)
    worst_depth = 0.0
    for a in acts:
        sc, oc, rc_, dc, _ = env_c.step_fn(sc, a)
        sg, og, rg, dg, _ = env_g.step_fn(sg, a.to(dev))
        if not torch.equal(dc, dg.cpu()) or (rc_ - rg.cpu()).abs().max() > 1e-5:
            fail("env step on the card disagrees with the CPU")
        dd = (oc["depth"] - og["depth"].cpu()).abs()
        if (dd > 1e-4).float().mean() > 1e-3:
            fail(f"depth on the card disagrees with the CPU: {dd.max().item()}")
        worst_depth = max(worst_depth, dd.max().item())
    policy_c = make_pointnav_resnet_policy(4, device="cpu")
    policy_c.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
    hid = torch.zeros(8, 1, 2, 512)
    prev = torch.zeros(8, dtype=torch.int32)
    with torch.no_grad():
        lc, vc, _ = policy_c(oc, hid, prev, torch.zeros(8))
        lg, vg, _ = policy({k: v.to(dev) for k, v in oc.items()}, hid.to(dev), prev.to(dev), torch.zeros(8, device=dev))
    policy_err = max((lc - lg.cpu()).abs().max().item(), (vc - vg.cpu()).abs().max().item())
    if policy_err > 3e-2:
        fail(f"policy on the card disagrees with the CPU: {policy_err}")
    # one update from the same weights and the same batch on both devices;
    # with one minibatch the loss does not depend on the permutation
    upd = PPOConfig(num_steps=4, ppo_epoch=2, num_mini_batch=1)
    trained_start = {k: v.detach().cpu().clone() for k, v in policy.state_dict().items()}

    def failing(rows):
        return {k: r for k, r in rows.items() if r[0] < UPDATE_TENSOR_SHARE or not r[1]}

    def pooled(rows):
        return sum(r[0] * trained_start[k].numel() for k, r in rows.items()) / sum(
            trained_start[k].numel() for k in rows)

    # bf16, as deployed, from the policy the paths above trained: the stem's
    # and first blocks' gradients carry bf16 rounding noise of the order of
    # their size (20-35% in either framework, tests/test_torch_ppo.py), and
    # Adam's first steps turn it into sign flips there, so only the losses
    # and the pooled share are gated
    data = update_data(trained_start, env_c, env_g, upd)
    (m_g, d_g), (m_c, d_c) = (one_update(torch.bfloat16, dev, trained_start, data, upd),
                              one_update(torch.bfloat16, "cpu", trained_start, data, upd))
    loss16 = max(abs(m_g[k] - m_c[k]) for k in m_g)
    rows16 = per_tensor(d_g, d_c, upd.lr)
    low16 = min(rows16, key=lambda k: rows16[k][0])
    unchanged16 = [k for k, r in rows16.items() if not r[1]]
    if loss16 > BF16_ATOL or pooled(rows16) < BF16_POOLED_SHARE or unchanged16:
        fail(f"the bf16 update on the card disagrees with the CPU: losses {loss16}, pooled share within lr/10 "
             f"{pooled(rows16)}, unchanged tensors {unchanged16}")
    # float32 from fixed starts built on the CPU (check_start), not the
    # policy the paths above trained on the card, whose weights change from
    # run to run: at some weights a float32 gradient element's sign, or a
    # tied stem max-pool window, is decided by rounding, and Adam makes that
    # a 2 lr change (PERF.md, check_diagnosis.py). On both devices (no
    # TF32), cuDNN's deterministic algorithms on the card, so the gate reads
    # the same in every run: the algorithm itself, held per tensor. Every
    # start is read before the gate decides.
    f32 = {}
    for seed in CHECK_SEEDS:
        fixed_start = check_start(env_c, upd, seed)
        data = update_data(fixed_start, env_c, env_g, upd)
        (m_g, d_g), (m_c, d_c) = (one_update(torch.float32, dev, fixed_start, data, upd, deterministic=True),
                                  one_update(torch.float32, "cpu", fixed_start, data, upd))
        rows32 = per_tensor(d_g, d_c, upd.lr)
        low32 = min(rows32, key=lambda k: rows32[k][0])
        f32[seed] = dict(loss=max(abs(m_g[k] - m_c[k]) for k in m_g), failing=failing(rows32), low=low32,
                         low_share=rows32[low32][0], outside=sum(int(((d_g[k] - d_c[k]).abs() > upd.lr / 10).sum())
                                                                 for k in d_c))
        if seed == CHECK_SEEDS[0]:
            # the same CPU update with the pool backward's gradient shifted
            # one column (a fault confined to the stem's convolution and
            # GroupNorm) must fail that gate
            plain_bwd = pool.max_pool_3x3s2_bwd_plain
            _, d_f = one_update(torch.float32, "cpu", fixed_start, data, upd,
                                max_pool_3x3s2_bwd_plain=lambda x, y, dy: torch.roll(plain_bwd(x, y, dy), 1, dims=3))
            rows_f = per_tensor(d_g, d_f, upd.lr)
            caught = failing(rows_f)
        del data
    readings = "; ".join(
        f"seed {seed}: losses max diff {r['loss']:.3g}, {r['outside']} elements outside lr/10, lowest per-tensor "
        f"share {r['low_share']:.4f} ({r['low']})" for seed, r in f32.items())
    if any(r["loss"] > F32_ATOL or r["failing"] for r in f32.values()):
        fail(f"the float32 update on the card disagrees with the CPU (tensors under {UPDATE_TENSOR_SHARE} within "
             f"lr/10 or unchanged: " + ", ".join(f"seed {s_}: {r['failing']}" for s_, r in f32.items())
             + f"): {readings}")
    if not caught:
        fail("the float32 update gate passes a planted fault in the pool backward")
    log(f"[check] card vs CPU: dones/rewards equal over 3 steps, max depth diff {worst_depth:.3g}, "
        f"policy logits/values max diff {policy_err:.3g}; one update (N=8, T=4, 2 epochs, lr {upd.lr}) from the "
        f"same weights and batch on both: bf16 from the trained policy, losses max diff {loss16:.3g}, share of "
        f"elements within lr/10 {pooled(rows16):.4f} pooled, lowest per tensor {rows16[low16][0]:.4f} ({low16}); "
        f"float32 from {len(CHECK_SEEDS)} starts, each a seed after {CHECK_CPU_STEPS} train steps on the CPU (cuDNN "
        f"deterministic on the card), all {len(rows32)} trained tensors changed on both devices and at least "
        f"{UPDATE_TENSOR_SHARE} within lr/10 from each: {readings}; planted fault (pool backward shifted one column, "
        f"seed {CHECK_SEEDS[0]}) fails {len(caught)} of them, the stem convolution at "
        f"{rows_f['net.encoder.backbone.stem.weight'][0]:.4f}")

    # ---- 8. the panoramic main path: equirect depth+RGB at 128x256 ----------
    # (after [check], so that the card-vs-CPU update meets the card in the
    # state the earlier paths leave, not after a 47 GiB train step)
    del train_learner, scan_train
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    pano_policy = make_pointnav_resnet_policy(
        len(pano_env.actions), backbone="resnet18", hidden_size=512, input_hw=(PANO["height"], PANO["width"]))
    pano_learner = PPOLearner(pano_env, pano_policy, PPOConfig(num_steps=T_steps))
    zero_counts()
    prs = pano_learner.init(seed=6)
    prs, pbatch, plast, _, _ = pano_learner.collect_rollout(prs)  # warm-up
    pwalls = []
    for _ in range(PANO_ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prs, pbatch, plast, _, pstats = pano_learner.collect_rollout(prs)
        torch.cuda.synchronize()
        pwalls.append(time.perf_counter() - t0)
    pano_launches = path_counts("panoramic path", raycast_index_t=1 + (1 + PANO_ROLLOUTS) * T_steps)
    pdepth = pbatch.obs["depth"]
    if pdepth.shape != (T_steps, BENCH["num_envs"], PANO["height"], PANO["width"], 1) or not torch.isfinite(
            pdepth.float()).all():
        fail(f"bad panoramic depth frames {tuple(pdepth.shape)}")
    for name, x in (("values", pbatch.values), ("rewards", pbatch.rewards), ("last_value", plast)):
        if not torch.isfinite(x).all():
            fail(f"non-finite {name} on the panoramic path")
    psps = sorted(steps / w for w in pwalls)
    pstate = prs.env_state
    pctx = pano_env._make_ctx(pstate)
    ppose = (pano_env.pack, pctx.sid, pstate.pos + cam_offset, pstate.yaw, pstate.pitch)
    pkw = dict(pano_hw, projection="equirect")
    psplit_r, _ = render_split(ppose, pkw, 5)
    with torch.no_grad():
        ppolicy_ms = cuda_ms(lambda: pano_policy(prs.obs, prs.hidden, prs.prev_action, prs.not_done), 5)
    log(f"[pano] {gpu}: env-steps/s median {psps[PANO_ROLLOUTS // 2]:.1f} over {PANO_ROLLOUTS} rollouts "
        f"(min {psps[0]:.1f}, max {psps[-1]:.1f}; walls ms {[round(w * 1e3, 1) for w in pwalls]} for "
        f"{BENCH['num_envs']}x{T_steps}, 128x256 equirect depth+RGB); per step: "
        f"{split_text(psplit_r, 'rays and features')}, policy {ppolicy_ms:.3f} ms; share of depth under max_depth "
        f"{share(pdepth < 1.0):.4f}; episodes done {int(pstats['done_count'].item())}, launches {pano_launches}")
    index_row["launches"] = pano_launches["raycast_index_t"]
    del pbatch, plast, pano_learner
    _, prates, psplit, pmetrics, ppeak = train_path(
        "pano-train", PPOLearner(pano_env, pano_policy, PPOConfig(**TRAIN)), 7, PANO_TRAIN_STEPS)
    pano_train_launches = path_counts(
        "panoramic train path", raycast_index_t=1 + (1 + PANO_TRAIN_STEPS) * T_steps,
        max_pool_3x3s2_bwd=(1 + PANO_TRAIN_STEPS) * TRAIN["ppo_epoch"] * TRAIN["num_mini_batch"])
    log(f"[pano-train] {gpu}: train env-steps/s {[round(r, 1) for r in prates]} over {PANO_TRAIN_STEPS} train steps; "
        f"per step rollout ms {[round(x, 1) for x in psplit['rollout'][1:]]}, update ms "
        f"{[round(x, 1) for x in psplit['update'][1:]]} (warm-up {psplit['rollout'][0]:.1f} + "
        f"{psplit['update'][0]:.1f}); peak memory {ppeak / 2**30:.2f} GiB; last losses "
        + ", ".join(f"{k} {v:.4f}" for k, v in pmetrics.items() if k.startswith("losses/"))
        + f"; launches {pano_train_launches}")
    torch.cuda.empty_cache()

    # the scan env with the same cameras: the culled kernel at every render
    zero_counts()
    ps_state, ps_obs = pano_scan_env.reset_fn()
    gen_a = torch.Generator(device=dev).manual_seed(8)
    for _ in range(PANO_SCAN["steps"]):
        acts = torch.randint(1, 4, (PANO_SCAN["num_envs"],), generator=gen_a, device=dev, dtype=torch.int32)
        ps_state, ps_obs, ps_r, _, _ = pano_scan_env.step_fn(ps_state, acts)
    torch.cuda.synchronize()
    ps_launches = path_counts("panoramic scan path", raycast_culled_t=1 + PANO_SCAN["steps"])
    psd = ps_obs["depth"]
    if psd.shape != (PANO_SCAN["num_envs"], PANO["height"], PANO["width"], 1) or not torch.isfinite(psd).all() \
            or not torch.isfinite(ps_r).all():
        fail("bad frames or rewards on the panoramic scan path")
    psctx = pano_scan_env._make_ctx(ps_state)
    pspose = (spack, psctx.sid, ps_state.pos + cam_offset, ps_state.yaw, ps_state.pitch)
    pssplit, _ = render_split(pspose, pkw, 5, warmup=1)
    log(f"[pano-scan] {gpu}: N={PANO_SCAN['num_envs']} reset + {PANO_SCAN['steps']} env steps, 128x256 equirect "
        f"depth+RGB on the {lod.num_triangles}-triangle scene; per {split_text(pssplit)}; "
        f"share of depth under max_depth {share(psd < 1.0):.4f}; launches {ps_launches}")
    culled_row["launches"] = ps_launches["raycast_culled_t"]

    # ---- 9. the culled route against the all-chunks oracle ----------------
    # #7's frames on a few envs of the scan equirect reset against the index
    # kernel #3 over every chunk whose LOD band holds the camera (the others
    # zeroed in per-env scene matrices): the culled route tests only its K
    # nearest occlusion-bounded chunks per 1024-ray tile
    n_g = CULLED_GUARD_ENVS
    gpose = (spack, ps_sid[:n_g], ps_cam[:n_g], ps0.yaw[:n_g], ps0.pitch[:n_g])
    kernel, args, kwargs, gdirs = rc.closest_hit_call(*gpose, **pano_hw, projection="equirect")
    t_c, a_c = kernel(*args, **kwargs)
    hit_c = a_c[:, 7] > 0.5
    cb = spack.chunk_bounds[ps_sid[:n_g].long()]
    dist_g = torch.linalg.vector_norm(cb[..., :3] - ps_cam[:n_g, None, :], dim=-1)
    band = (cb[..., 3] > 0) & rc._lod_band_ok(cb, dist_g[:, None, :])[:, 0]  # (n_g, NC)
    mats = spack.tri_mat[ps_sid[:n_g].long()] * band.repeat_interleave(C_scan, dim=1)[:, None, None, :]
    t_o, i_o = rk.raycast_index_t(
        mats.contiguous(), torch.arange(n_g, dtype=torch.int32, device=dev),
        rc.ray_features_t(ps_cam[:n_g, None, :].expand(-1, R_pano, -1), gdirs, 2048), ray_tile=2048)
    del mats
    hit_o = i_o >= 0
    culled_hitmatch = share(hit_o == hit_c)
    culled_t_agree = share((t_o - t_c).abs()[hit_o & hit_c] < 5e-3)
    if culled_hitmatch < CULLED_HITMATCH or culled_t_agree < CULLED_T_AGREE:
        fail(f"[exactness-culled] the culled route against the all-chunks oracle: hitmatch {culled_hitmatch} "
             f"(gate {CULLED_HITMATCH}), t-agree@5mm {culled_t_agree} (gate {CULLED_T_AGREE})")
    log(f"[exactness-culled] 128x256 equirect, {n_g} envs of the scan reset: culled_hitmatch {culled_hitmatch:.6f} "
        f"(gate {CULLED_HITMATCH}), culled_t_agree_5mm {culled_t_agree:.6f} (gate {CULLED_T_AGREE}) (hit fraction "
        f"{share(hit_c):.4f}; oracle {band.sum(-1).float().mean().item():.1f} band-valid chunks of {band.shape[1]}, "
        f"deployed {args[2].shape[2]} per 1024-ray tile)")

    # ---- 10. dynamic geometry: three boxes of 12 triangles per env ---------
    corners = torch.tensor([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=torch.float32, device=dev)
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                          [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], device=dev)

    def box_geometry(cam, yaw, seed):
        """DYN["objects"] yawed boxes of 12 triangles per env, 0.5-1.1 m in
        front of the camera (the rearrangement generator's object count and
        box faces)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        n, k = cam.shape[0], DYN["objects"]

        def u(*shape):
            return torch.rand(shape, generator=g, device=dev)

        fwd = torch.stack([-torch.sin(yaw), torch.zeros_like(yaw), -torch.cos(yaw)], -1)[:, None]
        side = torch.stack([torch.cos(yaw), torch.zeros_like(yaw), -torch.sin(yaw)], -1)[:, None]
        centre = cam[:, None] + fwd * (0.5 + 0.6 * u(n, k, 1)) + side * (0.8 * u(n, k, 1) - 0.4)
        centre[..., 1] = cam[:, None, 1] - 0.9 + u(n, k)
        a = u(n, k) * 2 * np.pi
        c_, s_, z_, o_ = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
        rot = torch.stack([torch.stack([c_, z_, s_], -1), torch.stack([z_, o_, z_], -1),
                           torch.stack([-s_, z_, c_], -1)], -2)  # (n, k, 3, 3) about +y
        v = torch.einsum("nkij,nkcj->nkci", rot, corners * (0.1 + 0.15 * u(n, k, 1, 3))) + centre[:, :, None]
        tri = v[:, :, faces].reshape(n, 12 * k, 3, 3)
        return dict(v0=tri[:, :, 0], e1=tri[:, :, 1] - tri[:, :, 0], e2=tri[:, :, 2] - tri[:, :, 0],
                    valid=torch.ones(n, 12 * k, dtype=torch.bool, device=dev),
                    color=(0.3 + 0.7 * u(n, k, 3)).repeat_interleave(12, 1),
                    sem=(DYN["sem_base"] + torch.arange(k, device=dev)).repeat_interleave(12)[None].expand(n, -1))

    head_pitch = DYN["pitch"]
    st_b, _ = env.reset_fn()
    sid_b, cam_b = env._make_ctx(st_b).sid.to(torch.int32), (st_b.pos + cam_offset).float()
    dyn_cases = (
        ("index", (env.pack, sid_b, cam_b, st_b.yaw, torch.full_like(st_b.pitch, head_pitch)), hw,
         dict(raycast_index_t=1)),
        ("block", (spack, sid0, cam0, st0.yaw, torch.full_like(st0.pitch, head_pitch)), hw,
         dict(raycast_exactsel_t=1, cullmask_t=1)),
        ("culled", ps_pose, dict(pano_hw, projection="equirect"), dict(raycast_culled_t=1)),
    )
    dyn_rows = {}
    for i, (route, pose, kw, static_launches) in enumerate(dyn_cases):
        dyn = box_geometry(pose[2], pose[3], 9 + i)
        if rc.render_route(pose[0], kw["height"], kw["width"], kw.get("projection", "pinhole"), dynamic=True) != route:
            fail(f"[dynamic] the {route} case takes another route")
        static = rc.render_batch(*pose, **kw)
        zero_counts()
        frames = rc.render_batch(*pose, dynamic=dyn, **kw)
        torch.cuda.synchronize()
        got = path_counts(f"{route} render with dynamic geometry",
                          **{**static_launches, "raycast_index_t": static_launches.get("raycast_index_t", 0) + 1})
        # the same render with #3's plain version swapped in (in this script only)
        with mock.patch.object(rc, "raycast_index_t", rk.raycast_index_t.plain):
            frames_p = rc.render_batch(*pose, dynamic=dyn, **kw)
        for k in frames:
            if not torch.equal(frames[k], frames_p[k]):
                fail(f"[dynamic] {route} route: the {k} frames differ from those with raycast_index_t's plain "
                     f"version on {share(frames[k] != frames_p[k]):.6f} of values")
        if (static["semantic"] >= DYN["sem_base"]).any() or not torch.isfinite(frames["depth"]).all():
            fail(f"[dynamic] {route} route: bad static or merged frames")
        merged = share(frames["semantic"] >= DYN["sem_base"])
        reps = 3 if route == "culled" else 5
        dyn_rows[route] = dict(
            merged=merged, extra_index_launches=got["raycast_index_t"] - static_launches.get("raycast_index_t", 0),
            ms=cuda_ms(lambda: rc.render_batch(*pose, dynamic=dyn, **kw), reps, warmup=1),
            static_ms=cuda_ms(lambda: rc.render_batch(*pose, **kw), reps, warmup=1))
        own = ""
        if route == "index":
            # without the boxes this render takes the pinhole fast path; the
            # index route's own static render is the merge's baseline
            with mock.patch.object(rc, "render_route", lambda *a, **k: "index"):
                own_ms = cuda_ms(lambda: rc.render_batch(*pose, **kw), reps, warmup=1)
            dyn_rows[route]["static_route_ms"] = own_ms
            own = f" (the pinhole fast path), {own_ms:.3f} ms on the index route without them"
        log(f"[dynamic] {route} route (N={pose[1].shape[0]}, {kw['height']}x{kw['width']} "
            f"{kw.get('projection', 'pinhole')}, {12 * DYN['objects']} triangles per env padded to 128): "
            f"{merged:.4f} of pixels from the boxes; frames equal to those with raycast_index_t's plain version; "
            f"render {dyn_rows[route]['ms']:.3f} ms with the boxes, {dyn_rows[route]['static_ms']:.3f} ms without"
            f"{own}; {dyn_rows[route]['extra_index_launches']} extra raycast_index_t launch per render")
        if merged == 0.0:
            fail(f"[dynamic] {route} route: no pixel shows a box")

    # ---- 11. the flagship checkpoint evaluated on the card -----------------
    from habitat_torch.baselines.flagship import flagship_eval

    torch.cuda.empty_cache()
    zero_counts()
    for p in plain_watch:
        p.start()
    fe = flagship_eval()
    for p in plain_watch:
        p.stop()
    if plain_on_card:
        fail(f"[flagship-eval]: plain versions ran on card tensors: {sorted(set(plain_on_card))}")
    # the reset's render and one per env step, each through #1
    fe_launches = path_counts("flagship eval", raycast_fused_sel_t=1 + fe["env_steps"])
    sel["flagship_eval_launches"] = fe_launches["raycast_fused_sel_t"]
    log(f"[flagship-eval] {gpu}: {fe['episodes']} episodes, success {fe['success']:.4f}, SPL {fe['spl']:.4f} "
        f"(soft SPL {fe['soft_spl']:.4f}; the JAX package's {FLAGSHIP['success']} / {FLAGSHIP['spl']} on the same "
        f"episodes, gate +-{FLAGSHIP['tol']}); {fe['env_steps']} env steps at N=64 in {fe['wall_s']:.1f} s = "
        f"{fe['env_steps_per_s']:.1f} env-steps/s (set-up {fe['setup_s']:.1f} s); raycast_fused_sel_t launches "
        f"{fe_launches['raycast_fused_sel_t']} (1 + one per env step), no plain version on a card tensor")
    if not (fe["episodes"] == FLAGSHIP["episodes"] and abs(fe["success"] - FLAGSHIP["success"]) <= FLAGSHIP["tol"]
            and abs(fe["spl"] - FLAGSHIP["spl"]) <= FLAGSHIP["tol"]):
        fail(f"[flagship-eval] {fe} against {FLAGSHIP}")

    # ---- 12. rearrangement physics and the arm (PyTorch ops, no kernel) ---
    log(f"[contacts] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    zero_counts()
    contacts_phase(gpu, dev)
    path_counts("contacts")
    zero_counts()
    arm_phase(gpu, dev)
    path_counts("arm")

    # ---- 13. vision Pick trained, and Pick under contacts ----------------
    log(f"[pick] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    pick_launches, pick_checks = pick_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    index_row["pick_launches"] = pick_launches["raycast_index_t"]
    index_row["pick_head_render"] = pick_checks["index"]
    pool_row["pick_launches"] = pick_launches["max_pool_3x3s2_bwd"]
    pool_row["pick_minibatch"] = pick_checks["pool"]
    torch.cuda.empty_cache()
    pc_launches = pick_contacts_phase(gpu, dev, zero_counts, path_counts)
    index_row["pick_contacts_launches"] = pc_launches["raycast_index_t"]

    # ---- 14. the config path: run.main, env_from_config, declared actions -
    log(f"[config] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    cf_launches = config_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["config_train_launches"] = cf_launches["train"]["raycast_fused_sel_t"]
    sel["config_eval_launches"] = cf_launches["eval"]["raycast_fused_sel_t"]
    pool_row["config_train_launches"] = cf_launches["train"]["max_pool_3x3s2_bwd"]

    # ---- 15. ObjectNav, ImageNav and the Gaussian actor-critic -------------
    for tag, phase in (("objectnav", objectnav_phase), ("imagenav", imagenav_phase), ("pick-arm", pick_arm_phase)):
        log(f"[{tag}] starts {time.perf_counter() - t_start:.1f} s after the start")
        torch.cuda.empty_cache()
        got = phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
        if tag == "objectnav":
            sel["objectnav_env_launches"] = got["env"]["raycast_fused_sel_t"]
            sel["objectnav_train_launches"] = got["train"]["raycast_fused_sel_t"]
            pool_row["objectnav_train_launches"] = got["train"]["max_pool_3x3s2_bwd"]
        elif tag == "imagenav":
            sel["imagenav_goal_table_launches"] = got["table"]["raycast_fused_sel_t"]
            sel["imagenav_env_launches"] = got["env"]["raycast_fused_sel_t"]
            sel["imagenav_train_launches"] = got["train"]["raycast_fused_sel_t"]
            pool_row["imagenav_train_launches"] = got["train"]["max_pool_3x3s2_bwd"]
        else:
            index_row["pick_arm_train_launches"] = got["train"]["raycast_index_t"]
            index_row["pick_arm_eval_launches"] = got["eval"]["raycast_index_t"]
            pool_row["pick_arm_train_launches"] = got["train"]["max_pool_3x3s2_bwd"]

    # ---- 16. DD-PPO (the ddppo_pointnav recipe), 2 ranks, the PPO switches -
    log(f"[ddppo] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    dd = ddppo_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["ddppo_launches"] = dd["raycast_fused_sel_t"]
    pool_row["ddppo_launches"] = dd["max_pool_3x3s2_bwd"]
    torch.cuda.empty_cache()
    ddppo_two_rank_phase(gpu, dev)
    zero_counts()
    ppo_switches_phase(gpu, dev)

    # ---- 17. behavior cloning and the hierarchical trainers ---------------
    log(f"[bc] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    bc_launches, bc_pool = bc_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["bc_launches"] = bc_launches["raycast_fused_sel_t"]
    pool_row["bc_launches"] = bc_launches["max_pool_3x3s2_bwd"]
    pool_row["bc_update_input"] = bc_pool
    log(f"[hrl] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    hrl_phase(gpu, dev, zero_counts, path_counts)

    # ---- 18. EQA and VLN, the EQA imitation trainers, the agents -----------
    log(f"[vln] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    vln_launches, vln_pool = vln_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["vln_launches"] = vln_launches["raycast_fused_sel_t"]
    pool_row["vln_launches"] = vln_launches["max_pool_3x3s2_bwd"]
    pool_row["vln_update_input"] = vln_pool
    log(f"[eqa-il] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    sel["eqa_il_launches"] = eqa_il_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    log(f"[eqa-referent] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    eqa_referent_phase(gpu, dev, zero_counts, path_counts)
    log(f"[agents] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    sel["agents_launches"] = agents_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    log(f"[env-api] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    sel["env_api_launches"] = env_api_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    log(f"[sim-api] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    sel["sim_api_launches"], _ = sim_api_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    log(f"[obs-transforms] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    tf_launches, tf_checks = obs_transforms_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["obs_transforms_launches"] = tf_launches["raycast_fused_sel_t"]
    sel["obs_transforms_faces"] = tf_checks["checks"]["#1"]
    index_row["obs_transforms_launches"] = tf_launches["raycast_index_t"]
    index_row["obs_transforms_equirect"] = tf_checks["checks"]["#3"]

    # ---- 20. social navigation, two-agent PPO, the hab3 humanoid lane -------
    log(f"[social] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    social_launches, social_checks = social_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    index_row["social_vision_launches"] = social_launches["raycast_index_t"]
    index_row["social_humanoid_frame"] = social_checks["index"]
    pool_row["social_vision_launches"] = social_launches["max_pool_3x3s2_bwd"]
    pool_row["social_vision_minibatch"] = social_checks["pool"]
    log(f"[hab3] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    hab3_launches, hab3_index = hab3_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    index_row["hab3_launches"] = hab3_launches["raycast_index_t"]
    index_row["hab3_head_render"] = hab3_index

    # ---- 21. articulated scenes (receptacles, AO states, URDF), the reach task -
    log(f"[art-scene] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    art_launches, art_index = art_scene_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    index_row["art_scene_launches"] = art_launches["raycast_index_t"]
    index_row["art_scene_cabinet_frame"] = art_index
    log(f"[reach] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    reach_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)

    # ---- 22. vector envs, eval videos, the CLIP backbones ------------------
    log(f"[vector-env] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    vec_launches = vector_env_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["vector_env_threaded_launches"] = vec_launches["threaded"]
    sel["vector_env_process_launches"] = vec_launches["process"]
    log(f"[eval-video] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    sel["eval_video_launches"] = eval_video_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    log(f"[clip] starts {time.perf_counter() - t_start:.1f} s after the start")
    torch.cuda.empty_cache()
    clip_launches = clip_phase(gpu, dev, zero_counts, path_counts, plain_watch, plain_on_card)
    sel["clip_pointnav_launches"] = clip_launches["pointnav"]
    sel["clip_objectnav_launches"] = clip_launches["objectnav"]

    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddppo-rank"]:
        sys.path.insert(0, ROOT)
        sys.exit(ddppo_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
