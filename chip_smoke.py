#!/usr/bin/env python3
"""Drive the PyTorch port's physics on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--profile PATH] [--parent-csrc DIR]

Phases, in order; any failure ends the script with a non-zero exit:

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the CUDA kernels from `robogym_torch/csrc/` and prints
   what `nvcc -Xptxas -v` reports per kernel.
3. Compile, on the host while nvcc builds the kernels (a thread beside
   the build): the port's own compiler (`mjcf/compiler.py`) compiles each of
   the 25 stand-in worlds (`worlds/compile.compile_world(name, "cuda")`,
   which builds them as `tools/build_locked_like_snapshot.py` builds their
   committed snapshots with the JAX compiler) and prints each world's
   seconds; each world is held to its snapshot: the same keys, integer,
   static and name fields and float fields exactly, but where the card's
   host rounds `np.linalg.eigh` (a body's principal axes) or orders a
   scipy hull otherwise, each body's inertia tensor rebuilt from
   `body_iquat` and `body_inertia`, and each hull's verts and face planes
   as sets, within `COMPILE_TOL` of their largest entry; the phase prints
   which fields needed that rule. Then `envs/rearrange/blocks.
   compile_worlds` compiles the rearrange env's worlds (main, solver) from
   the stand-in's builder (`rearrange_blocks_like.world_xml_builder`).
   The locked env (and the default wrapper stack around it) runs on the
   compiled dactyl-shaped world, and the rearrange env (and the joint-mode
   env of the reach_helper path, on its main world) on those worlds.
4. State, B=1024 from seed 0 on five worlds: the locked-like world
   (`robogym_torch/worlds/locked_like.npz`) settled for 20 substeps so
   contacts are live; the rearrange goal-settle world
   (`blocks_settle_like.npz`) settled for 40 substeps so the blocks rest on
   the table and on each other; the hand-only world (`locked_like_hand.npz`)
   with hinges started past their limits so joint-limit rows are live; the
   table-setting goal-settle world (`table_setting_like.npz`, five free
   meshes, the spoon on the plate in every other env) settled for 40
   substeps; the dactyl-shaped world (`dactyl_locked_like.npz`, nv=36: the
   cube and the target on three slides and a ball, a box palm) settled for
   20 substeps. Then the locked env (`envs/dactyl/locked.py`) on the
   dactyl-shaped world: its construction (the zero-control settle) and
   `LockedEnv.reset` at B=1024 from seed 0 (time, retries, share of envs
   with the cube on the palm; every state finite); and the default dactyl
   wrapper stack around it (`wrappers.apply_dactyl_wrappers(env,
   randomize=True)`, as bench.py wraps the JAX env under BENCH_WRAPPED=1)
   reset at B=1024; and the rearrange blocks env
   (`envs/rearrange/blocks.make_env` with bench.py's BENCH_ENV=blocks
   configuration, `REARRANGE_CONFIG`: 8 object slots, 5 blocks, TCP control
   through the mocap_ik dual sim) on the UR16e-shaped worlds
   (`rearrange_blocks_like.npz`, nv=60, and the solver sim's
   `rearrange_solver_like.npz`, nv=12), built (its 200-substep settle at
   B=1) and reset at B=1024 (its 200-substep object settle; times, share
   of envs with every block on the table; states and obs finite); the
   same for blocks_train (`blocks_train.make_env(*BLOCKS_TRAIN_CONFIG)`: 8
   blocks, each episode's cuboids, pick-up and stacking goals, each goal
   settled in the objects-only settle world `rearrange_settle_like.npz`,
   nv=48, the soft placement mask and the masked observations; its block
   sizes, its first goals' heights and placement mask) and for dominos
   (`dominos.make_env(*DOMINOS_CONFIG)` on `rearrange_dominos_like.npz`,
   blocks of 0.2 x 1 x 2 times the block's half-size, train goals); and
   the face-perpendicular Rubik's env (`envs/dactyl/face_perpendicular.py`)
   on the cubelet world (`rubik_face_like.npz`, nv=48: the hand, a cube of
   26 box cubelets whose two z faces turn on hinges, each face held to its
   driver by 8 joint equality rows), bare and in the face stack (the
   default dactyl stack and the face drivers' damping,
   `wrappers.apply_face_wrappers`), each built (its settle at B=1) and
   reset at B=1024 (times, retries, share on the palm, the reset goals'
   types); and the full-perpendicular Rubik's env
   (`envs/dactyl/full_perpendicular.py`, face_free goals) on the
   20-cubelet world (`rubik_full_like.npz`, nv=96: the hand, 6 face
   centres on driver hinges and 20 cubelets on three hinges each, every
   piece hinge with friction loss), bare and in the full stack (the face
   stack and the perpendicular cube's size, `wrappers.apply_full_wrappers`),
   built and reset the same way (50 random quarter turns of the cube
   before the pose loop), with the share of envs whose cube is legal
   (`legal_share`) and the share above 32 live contacts; the reach env
   (`envs/dactyl/reach.make_env`, BASELINE config 1) on the reach stand-in
   world (`dactyl_reach_like.npz`, nv=24: the hand alone at the
   reference's mount pose over a floor, force-limited), built (its
   200-substep settle at B=1) and reset at B=1024 (each env's first goal
   from a 20-substep goal sim); a copy of it under an `EnvRandomization`
   whose simulation chain draws gravity, joint margins, geom solref, and
   `GenericSimRandomizer` on the `robot0:` dofs' damping and geoms'
   friction, its ADR values set by path (`REACH_ADR`), applied as per-env
   model fields on its reset state; and the locked env with
   `vision_observation_provider="dummy_vision"` built and reset at B=1024
   (its images (B, 3, 200, 200, 3) uint8 zeros, the goal images cached in
   `goal_aux`).
5. One phase per kernel: its inputs are captured from one substep or call
   of the path that runs it; the kernel and its plain version run on the
   same inputs on the card, and are compared and timed (CUDA events over 50
   launches, after a warm-up), with a library call beside them where one
   computes the same function. A (SPD inverse), B (fused CG solve), C and D
   (hull kernels) from a locked-like substep, A again (V=36) from a
   substep of the locked env's reset state (`@dactyl`), and H and G (the hull
   kernels on world verts) on the same winners placed in the world by
   `world_from_loc`, also held to C's and D's outputs bit for bit; B again
   (E=192, no scalar row) and E (box-box) from a settle-world substep; A
   again (V=24) and F (CG on a prebuilt J) from a hand-world substep; B
   without the Euler update from one `forward()` of the locked-like world;
   C and H on the winners of the table world's two manifold calls in one
   substep, its box-mesh group (`@table-box`: the table's 8 corners against
   the meshes, DX=6) and its mesh-mesh group (`@table`, V1=V2=64); each
   hull phase, E's phase and each phase of A also prints the kernel's
   layout (shared memory a block, registers, warps an SM, waves); A is held to
   1e-5 of the plain version's largest entry and, column by column, to a
   float64 inverse (`spd_readings`), on its path's matrices and on dense
   seeded SPD matrices of the same shape (`dense_spd`);
   B again on the inputs of the last substep of one wrapped env step,
   each env with its own timestep (`cg_full@dt`), and B with one timestep
   given once (stride 0) and as a (B,) tensor (stride 1) on the locked
   env's inputs, bit for bit;
   then, on the inputs of one rearrange env step from its reset state, A
   at the main sim's V=60 and the solver sim's V=12 (`@rearrange`,
   `@solver`), B on the solver sim's system (E=149, its 13 weld, connect
   and joint rows; kernel B takes EQ rows as the plain version's two-sided
   quadratic) and on the main sim's (E=239, V=60; checked to be within B's
   shared memory), and C (K=42 box-hull pairs), D (the fingers, K=1) and E
   (K=36) on the main sim's last substep; on the inputs of one
   blocks_train env step, A, B and E at the settle world's shapes from the
   last substep of its goal settle (`@settle8`: V=48, E=128 with 32 contact
   rows, K=36 box-box pairs), with the settle's live contacts per env
   against its budget of 32 (rows beyond it are dropped, as the JAX package
   drops them); E on the dominos world's pairs (`boxbox@dominos`, K=36);
   then the goal generators of reach, det-reach, stack, pick-and-place,
   attached, duplicate, dominos under `is_holdout` and wordblocks on the
   card at B=1024, each from its own draws, every active goal finite and on
   the table;
   on the inputs of the last substep of one face env step from its reset
   state, A and B at V=48 (`@face`: B's rows hold the 16 equality rows,
   the hand's 24 limits and 32 x 4 contact rows), C on the cubelets' and
   the palm's box-mesh pairs (K=32, V1=8, DX=6) and E on the palm's
   box-box pairs with the cubelets (K=26);
   on the inputs of the last substep of one full env step from its reset
   state, A at V=96 (`@full`: one env a block of 8 warps, with the
   linalg.inv and cholesky_inverse times beside it), the solve (E=218: the
   66 friction-loss rows of the piece hinges, the hand's 24 limits, 32 x 4
   contact rows) in B where `cg_kernel.fits` says so (`cg_full@full`, with
   its layout: smem an env, row groups in registers and spilled, envs an
   SM, waves), else in F on the size route (`cg@full`), C on the pieces'
   box-mesh pairs and E on the palm's box-box pairs; then the solver hop:
   a face_cube_solver reset of 16 envs, `goals_solver.solve_and_attach`
   (host time a solve), every plan non-empty and `solver_plan_empty` false
   after one step;
   on the inputs of the last substep of the reach env's physics from its
   reset state under a relative zero action (`@reach`), A and B at V=24
   (E=152), C on the palm's box-mesh pairs with the
   fingers (K=12, V1=8, DX=6) and D on the fingers' mesh-mesh pairs (K=8,
   V=64); then one substep of the reach model under effort control
   (`shadow_hand.effort_control_model`) at B=1024 with a seeded command in
   [-1, 1], `actuator_effort` held to the command to 1e-5, clipped where
   the control range [-1, 1] clips the force (the wrist, THJ4, THJ3);
   last the size route (`cg@wide`): a seeded synthetic system at V=96,
   E=408 (`wide_core_inputs`), above kernel B's shared memory, where
   `cg_full` takes the plain version's route with its solve in kernel F,
   and F keeps J in device memory; A on that system's M (V=96, one env a
   block of 8 warps, `spd_inverse@wide`); and A on dense seeded SPD
   matrices at V=160 (HUGE_V, one env a block of 16 warps,
   `spd_inverse@huge`) and at V=256 (DEV_V, above the largest V the
   kernel holds in shared memory: one env a block of 32 warps, the matrix
   in device memory, `spd_inverse@dev`); above 64 dofs each A phase checks
   that layout (the matrix in shared memory up to the largest V the build
   reports, `cuda.spd_inverse_info`, in device memory above).
6. Paths, each driven with every launch count set to 0 just before it and
   read just after; every qpos, qvel and qacc finite; every kernel's count
   equal to its count per substep or call times their number:
   the locked-like world, `step_n` for 10 env steps of 10 substeps
   (env-steps/s); one goal settle, 200 substeps of 1 ms on the settle world
   (substeps/s, settles/s); one env step of 10 substeps on the hand world;
   10 `forward()` calls on the locked-like world; one goal settle of the
   table world, 200 substeps (substeps/s, settles/s); one locked-like env
   step of 10 substeps, after each of which that substep's hull winners are
   placed in the world and passed to the world-vertex entry points; 10
   steps of the locked env (`LockedEnv.step`, 10 substeps each) from its
   reset state, actions uniform in [-1, 1] from a seeded generator, as
   bench.py drives the JAX env (env-steps/s, the reward sum, the episodes
   done, the share on the palm; every obs and reward finite); 10 steps of
   the wrapped env (`wrapped_env`) from its reset state, discrete actions
   uniform over the 11 bins from a seeded generator (env-steps/s beside
   the locked env's, the reward sum, the episodes done, the share on the
   palm, each overridden model field's spread across envs: every field
   differs across envs but the two that the dactyl-shaped world leaves
   at the compiled model's, `WRAPPED_SAME`, and the timestep changes at
   every step); 3 steps of the rearrange env (`rearrange_env`) from its
   reset state, actions uniform in [-1, 1] from a seeded generator
   (env-steps/s, construction and reset times, the reward sum by component,
   the episodes done, the env-steps with a block off the table, the share
   of envs with gripper-table contact; every obs and reward finite; the
   launches an env step are `PER_CALL["rearrange_env"]`); 2 steps of
   blocks_train (`blocks_train_env`: per env step the rearrange env's
   launches and `GOAL_SETTLE_SUBSTEPS` goal-settle substeps of 2 A, 1 B and 1 E, the resample
   drawn and settled for every env) and 1 step of dominos (`dominos_env`,
   the rearrange env's launches), each read as the rearrange env's path
   with its construction and reset times; 10 steps of the face env
   (`face_env`, actions uniform in [-1, 1]) and 10 of the face stack
   (`wrapped_face_env`, discrete actions), each with the locked env's
   launches a substep (2 A, 1 B, 1 C, 1 D, 1 E): env-steps/s, the share on
   the palm after the reset and after the steps, the goals drawn by type
   (flip, rotation) over the run, the largest |face angle|, the share of
   envs above the 32-contact budget at the last substep; for the stack
   each model field's spread (equal in every env only where the cubelet
   world gives the cube-size scale nothing to scale, `FACE_WRAPPED_SAME`)
   and `dof_damping` varying across envs on exactly the two driver dofs;
   5 steps of the full env (`full_env`) and 5 of the full stack
   (`wrapped_full_env`), read as the face paths, with the launches a
   substep of the route the system takes (2 A, 1 B or F, 1 C, 1 D, 1 E),
   `dof_damping` varying on exactly the six driver dofs and `geom_size`
   on exactly the 26 pieces; 5 steps of the reach env (`reach_env`,
   actions uniform in [-1, 1], one env in 8 pending a success before the
   first step, so that the goal sim runs on the gathered envs; the kept
   goals unchanged, the resampled ones finite: env-steps/s, construction
   and reset times, the success share, the goal sims and the envs they
   resampled; per
   substep 2 A, 1 B, 1 C, 1 D, the goal sims' substeps counted in) and 5
   of the randomized reach env (`randomized_reach_env`, read the same way,
   each randomized field varying across envs on exactly the rows its
   randomizer selects and equal to the compiled model's elsewhere); 3
   steps of the locked env with dummy vision (`locked_dummy_vision_env`,
   the locked env's launches; one env in 8 holds a pending success, so its
   goal resamples at the first step; the goal images read for exactly the
   envs that resample, and carried over as the same tensor in a step with
   none); 3 steps of the YCB env (`ycb_env`, `envs/rearrange/ycb.make_env`
   with 5 of 8 mesh slots on the YCB stand-in world, the five candidates of
   64 hull verts (`YCB_MESHES`), actions uniform in
   [-1, 1]: env-steps/s, construction and reset times, the candidates
   drawn per slot, `mesh_convex_vert` varying across envs on exactly the
   slots' meshes, live mesh-mesh and box-mesh contacts, the env-steps with
   an object off the table; per env step 160 A, 80 B, 121 C, 81 D: the
   main sim's box-mesh and mesh-mesh groups are C calls); 1 step of the
   same env under `stabilize_goal` (`ycb_stabilized_env`: its reset
   settles every env's first goal in the full model; one env in 8 pending
   a success before the step, so the goal settle runs, 200 substeps of the
   main model, on exactly the resampling envs; exactly those envs' goals
   change and are finite; the settle's seconds); and 3 steps of the
   stand-in holdout (`holdout_env`, built from its jsonnet config through
   `utils/env_utils.load_env`; its reset equal to the saved initial
   state; the live pairs of each round-geom group, sphere-mesh and
   cylinder-box, at every step, which must not be zero over the steps;
   per env step 160 A, 80 B, 81 C, 81 D).
7. Whole-step agreement: one substep through the kernels against one
   through the plain versions, at B=64 (the first 64 envs of phase 4's
   states), on the locked-like, settle, hand, table and dactyl-shaped
   worlds; every kernel routed to its plain
   version by name. Then one substep of the wrapped env's physics (each
   env's own model fields) at B=64 through the kernels, the plain
   versions and the plain versions in float64: the kernels' error against
   float64 at most NOISE_RATIO times the plain float32 version's. Then one
   substep of each rearrange world (main and solver sim) on the first 64
   envs of the rearrange_env path's last state, kernels against plain
   versions, held as the five worlds are. Then one env step's physics of
   the face env on the first 64 envs of each face path's last state (each
   env's own model fields under the stack), kernels against plain
   versions (and the same for the full env and its stack) by the CPU
   tests' nudge rule over the whole batch: per group
   of the env-step envelope, the largest difference at most twice the
   largest drift of 8 runs of the kernels from qvels nudged by 1e-6, or
   within the envelope. Then one substep of the reach env's physics on the
   first 64 envs of the reach path's last state, kernels against plain
   versions, as the five worlds; and one substep of the randomized reach
   env's physics (each env's own fields) at B=64 against the plain
   versions in float32 and float64, as the wrapped env's. Then one substep
   of the YCB env's and of the holdout's main world on the first 64 envs
   of their paths' last states (the YCB env's with each env's hulls),
   kernels against plain versions, as the rearrange worlds.
   Then the Newton path (`newton_step`, the
   locked-like world under `solver="newton"`, one substep at B=64 against
   the plain versions by the nudge rule), and substeps of the table
   setting's and the composer's main world (each env's own fields: hulls,
   masses, the composer's sub-geom offsets) on the first 64 envs of their
   paths' last states, 10 substeps by the nudge rule (`nudged_agreement`):
   their CG systems meet line-search near-ties, as the Rubik's envs'
   contacts meet chaos.

The Newton and mesh-family paths (B=1024): `newton_step`, 10 substeps of the
locked-like world under the Newton solve (2 A, 1 C, 1 D a substep: its
`forward_tail`, M^-1 for qacc_smooth, and `euler`; no B); and
`table_setting_env`, `chessboard_env`, `mixture_env` and `composer_env`,
each built by its `make_env` on its
stand-in world (`rearrange_mesh_family_like`), reset and stepped
`FAMILY_STEPS` times (160 A, 80 B, 121 C, 81 D an env step, as the YCB
env's; the composer's solve in B or, where `cg_kernel.fits` says no, in F),
every object on the table after the reset, the table setting's fixed goals
at their placements (the spoon turned by 0.38 rad), the composer's
`geom_pos` differing across envs on exactly its sub-geoms past the roots
and its sub-geoms' contacts live. Their kernels' inputs come from one env
step from each reset state (`capture_rearrange`, as the YCB env's) and
give the entries `spd_inverse@newton` and A, B and C `@tableware`,
`@chess`, `@mixture` and `@composer`, and C on each mesh world's box-mesh
call (`@ycb-box`, `@tableware-box`, ...) and on the solver sim's calls
(`hull_manifold@solver`, `hull_pair@solver`); the mixture's datasets are
each drawn.

A CG kernel's check follows float32 ties (`cg_readings`,
`tie_reference`): where an env leaves the plain version within 15
iterations, the plain version takes the kernel's choice wherever a float32
tie of the line search (two costs within `TIE_ULPS` x 2^-23 of the terms
summed into them) or of a row's state leaves it open, at most
`MAX_FORCED` times an env; an env that leaves within the early iterations
otherwise fails the check by name. The early check (1e-4 after 1 and 2
iterations) holds the kernel to that forced plain version. Then the
one-step check (`one_step_readings`) holds every iteration from the
kernel's own state, which B and F write to a trace (`cg_kernel.cg_full(...,
trace=True)`): the set-up against the plain version's, each iteration
against one plain iteration from the kernel's state after the one before
(a differing line-search pick excused only within the tie bound, then
forced), beta within the rounding bound of its two dot products, the
search direction against -M^-1 g + beta p, and the outputs against the
plain version's output stage on the kernel's last state. The noise check
(the error against a float64 run at most NOISE_RATIO times the plain
version's) is printed, and holds nothing. Each CG phase prints the excused
envs with their witnesses, for every field of the one-step check its
worst error over its tolerance, and the envs excused at a step.
`--parent-csrc DIR` also holds each CG phase's outputs (the trace pointer
null) and each of A's phases' outputs to the kernels built from DIR,
another checkout's `robogym_torch/csrc`, with `torch.equal`, and times
both in turns.

The training path (B=1024): `ppo_train`, the reach env from its reset
state with a policy of PPO_HIDDEN hidden units through a one-rank
`parallel.mesh`: PPO_STEPS `train.ppo.train_step`s (observe, clipped
Gaussian actions, one env step, one-step GAE, one PPO update) and a
PPO_ROLLOUT_STEPS-step `parallel.rollout.make_rollout_fn` with the policy
sampling; the reach env's launches a substep. It checks the losses and the
mean rewards finite, every parameter moved, the gradients finite and PPO's
ratio at the old parameters 1 within RATIO_TOL on one more batch, and
prints the train steps' env-steps/s, the update's device time and the loss
at each step. The host driver: `reach_helper`, the rearrange env in joint
control mode (`REACH_HELPER_CONFIG`) at B=16 driven by
`robot.reach_helper.reach_position` to a target REACH_HELPER_OFFSET rad
from its reset pose on every arm joint: every env reached and stopped
within REACH_HELPER_STEPS env steps (80 A, 40 B, 40 C, 40 D, 40 E an env
step).

The vision paths (B=1024): `locked_real_image_env`, the real-image locked
env on the dactyl-shaped world with the vision cameras
(`worlds/vision_like.py`), 200-pixel images of three cameras, a pool of 16
goals, cameras and lights randomized, reset and `REAL_IMAGE_STEPS` steps
(the locked env's launches a substep); env 0's `vision` held to the same
env rendered alone and shown to see the cube and the hand, `vision_goal`
the pool's image at `goal_idx`. `rearrange_vision_env`, the blocks env with
vision (front and wrist cameras), vision randomization, every stand-in
material, block goal rotations and the icp distance, reset and one step
(the rearrange env's launches and the goal image's fwd_position: 1 C, 1 D,
1 E). Each prints its rate, the renders' share of its steps, the
renderer's env chunks and the peak device memory.

To pay for the new paths the older ones run fewer steps (`ENV_STEPS` 2,
`FULL_STEPS` 1, one rearrange, blocks_train, YCB, holdout and family step,
`REAL_IMAGE_STEPS` 1, `REACH_HELPER_OFFSET` 0.02 rad, the settle and table_setting paths
`SETTLE_PATH_SUBSTEPS` 100), each kernel is timed over `REPS` launches, and the
YCB env is built and reset once: its reset state starts the ycb_env path
and, in a copy of the env under `stabilize_goal`, the ycb_stabilized_env
path. The dominos env, the blocks env with vision, blocks_train, the
holdout and the mesh-family envs take `OLDER_STABILIZE_STEPS` 1: their
resets' object settle is 40 substeps, not 200; so are blocks_train's goal
settles and the ycb_stabilized_env path's. The YCB env keeps 200: at its
state after 40 kernel B meets a line-search tie that the early CG check
does not excuse.
The real-image locked env, whose state no CG check reads either, takes
`OLDER_INITIAL_STEPS` 5: its construction's settle is 50 substeps, not
200. Every env construction prints its seconds (`[construction]`), and a
B=1 settle runs once for all the constructions whose settle reads an
equal model, start state and substep count (`SettleMemo`): blocks_train
and the reach helper take the rearrange env's, the dummy-vision env (now
at the default 200 substeps) and examine's env the locked env's,
create_holdout's env the holdout env's. The settles of the other worlds
run ahead in a second process, started when the kernels are built (this
script with `--settles DIR`: the constructions of
`prefetch_constructions` in the state phase's order, each settle written
into DIR with its inputs); a construction takes the one its label names
there where model, start state and substeps equal its own field by field,
else runs its own. A B=1 settle is paced by the host, so the two
processes overlap; the second one ends before the kernel phases, and its
log is printed (`[prefetch]`). The `[compile]` phase runs on the
host while nvcc builds the kernels; it covers 25 worlds, the four dactyl
worlds that the port's builders (`cube_env.build_cube_world_xml`, the
face, full and reach builders) compose from the stand-in asset tree
(`worlds/dactyl_assets_like.write_assets`) among them. The locked env on
the composed dactyl world (`composed_locked_env`: built, reset at B=1024
and 2 steps, the locked env's launches a substep, its env-steps/s beside
`locked_env`'s) records its kernels' inputs as it runs, and A, B, C, D
and E are held on them (`@composed`). The scripts run on the card:
`examine.main` (the locked env by its path, `EXAMINE_STEPS` steps, its
random warmup cut to one env step, the trajectory recorded), then
`viewer.replay_npz` of the record through the raycaster at
`REPLAY_SIZE` (every frame checked: uint8, not black; ms a frame) and
`EnvReplayViewer(env).run(VIEWER_STEPS)`; `create_holdout.main` on the
stand-in holdout's config (one settle step; the saved npz has the
reference state's keys and shapes, finite values); each checks that the
kernels of its env were launched. Each reset's seconds are printed (`[state time]`). The
rearrange, blocks_train, dominos, YCB, holdout and mesh-family paths, one
env step each from their reset states, record their kernels' inputs as
they run (`captured`: the inputs of `one_step`, the step a separate
capture took before), and those kernels' phases run after the paths.
8. Summary: a `kernels` line and a `paths` line of JSON, the card's name
   and power limit, and last `{"ok": true, "device": {...}}`. The kernels
   line has an entry per phase of step 5: `k` for kernel k at the shapes
   of its first phase, `k@w` for its phase at world w's shapes; each entry
   counts the kernel's launches on the paths it stands for (C counts all
   its launches on the table world's path at both `@table` and
   `@table-box`, as the launch count does not tell the two calls apart; H,
   which no path runs on the table world, counts its launches on every path
   at `@table` and `@table-box`; the `@rearrange` and `@solver` entries
   of one kernel count all its launches on the rearrange_env path, both
   sims', and the `@settle8` and `@dominos` entries all its launches on
   the blocks_train_env and dominos_env paths, the `@face` entries their
   kernel's launches on the face_env path, the `@full` entries on the
   full_env path, the `@reach` entries on the reach_env path, the `@ycb`
   entries on the ycb_env path and the `@holdout` entries on the
   holdout_env path; `cg@wide` counts F's
   launches in the
   routed `cg_full` call of its phase, read the same way as a path's, and
   `spd_inverse@wide`, `spd_inverse@huge` and `spd_inverse@dev` A's
   launches in one call on their matrices).

`--profile PATH` also writes a device-time breakdown of three locked-like
substeps, with their wall time and the device's busy share, to PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024                      # envs of every path
ENV_STEPS = 2                     # env steps of the locked-like, locked, wrapped and face paths
FULL_STEPS = 1                    # env steps of the full and wrapped full paths
SOLVER_HOP_ENVS = 16              # envs of the full env's solver hop
N_ACTION_BINS = 11                # the default stack's discrete actions (wrappers/__init__.py)
HUGE_V = 160                      # kernel A's dense phase at 16 warps an env (161 to 240: 32)
DEV_V = 256                       # kernel A's dense phase in device memory (above 240 dofs)
SUBSTEPS = 10                     # substeps per env step (envs/core.py)
SETTLE_SUBSTEPS = 200             # one goal settle: stabilize_steps 5 x 40 substeps (blocks.py)
# stabilize_steps (the env's default 5) of the older rearrange paths:
# dominos, the blocks env with vision, blocks_train (its resets' and its
# goals' settles), the holdout and the mesh family (not the YCB env: at its
# state after a 40-substep object settle kernel B meets a line-search tie
# that the early CG check does not excuse), and of the ycb_stabilized_env
# path's goal settle: 1 x 40 substeps, which keeps the whole script within
# its time
OLDER_STABILIZE_STEPS = 1
GOAL_SETTLE_SUBSTEPS = OLDER_STABILIZE_STEPS * 40   # an older path's goal settle
# reset_initial_steps (the dactyl envs' default 20) of the real-image env,
# whose state no CG check reads: its construction's zero-control settle
# 5 x 10 substeps at B=1, not 200 (its world has the vision cameras, so it
# shares no settle)
OLDER_INITIAL_STEPS = 5
# seconds a construction waits for its settle from the prefetch process,
# and the state phase for that process to end
PREFETCH_WAIT_S = 300
# the examine path: env steps of `scripts/examine.py` (its random warmup
# cut to one env step: its state is read by no CG check), the replay's
# frame size and the EnvReplayViewer's steps
EXAMINE_STEPS = 5
EXAMINE_CONSTANTS = "@{'n_random_initial_steps': 1}"
REPLAY_SIZE = (320, 240)
VIEWER_STEPS = 2
SETTLE_PATH_SUBSTEPS = 100        # substeps of the settle and table_setting paths
SETTLE_START = 40                 # substeps that settle the goal-settle worlds' start states
FORWARD_CALLS = 5
REARRANGE_STEPS = 1               # env steps of the rearrange_env path
BLOCKS_TRAIN_STEPS = 1            # env steps of the blocks_train_env path
DOMINOS_STEPS = 1                 # env steps of the dominos_env path
# bench.py's BENCH_ENV=blocks configuration (constants, parameters)
REARRANGE_CONFIG = ({}, {"simulation_params": {"num_objects": 5}})
# env-steps/s of the locked_env and rearrange_env paths on the committed
# snapshots, before those paths ran on the port's own compiles (one run of
# this script on an NVIDIA H100 80GB HBM3, 700.00 W)
SNAPSHOT_RATES = {"locked_env": 1628.8, "rearrange_env": 245.2}
# blocks_train with every option of its slice: 8 blocks, cuboids exp-uniform
# in +-0.2 a group and axis, pick-up and stacking goals at 0.2 each, each goal
# settled in the objects-only settle world (stabilize_steps
# OLDER_STABILIZE_STEPS x 40 substeps), the soft placement mask and the
# masked observations
BLOCKS_TRAIN_CONFIG = ({"use_cuboid": True, "mask_obs_outside_placement_area": True,
                        "stabilize_steps": OLDER_STABILIZE_STEPS,
                        "goal_args": {"pickup_proba": 0.2, "stacking_proba": 0.2,
                                      "stabilize_goal": True, "soft_mask": True}},
                       {"simulation_params": {"num_objects": 8}, "object_scale_low": 0.2,
                        "object_scale_high": 0.2})
# dominos' default: train goals with the mod-180 rotation distance, 5 of 8
DOMINOS_CONFIG = ({"stabilize_steps": OLDER_STABILIZE_STEPS},
                  {"simulation_params": {"num_objects": 5}})
REACH_STEPS = 5                   # env steps of the reach and randomized reach paths
YCB_STEPS = 1                     # env steps of the ycb_env path
# The YCB paths' bank: the stand-in candidates of 64 hull verts, not the
# die (12 verts, padded). In an env that holds a padded mesh the plane-mesh
# contact picks verts by index (a fault of the reference that the port
# repeats: ROADMAP section 3, item 5), its objects sink and spin, and on
# such a batch's state one env of 1024 met a near-tie of kernel B's line
# search within 2 iterations, where the kernel took the float64 run's step
# and the float32 plain version the other (PERF.md, PR 19). The CPU tests
# run the die and the bank's padding.
YCB_MESHES = ["banana", "bottle", "bowl", "can", "cracker_box"]
YCB_CONFIG = ({}, {"simulation_params": {"num_objects": 5}, "mesh_names": YCB_MESHES})
HOLDOUT_STEPS = 1                 # env steps of the holdout_env path
NEWTON_SUBSTEPS = 5               # substeps of the newton_step path
FAMILY_STEPS = 1                  # env steps of each mesh-family path
# each mesh-family env's make_env arguments: the mixture's and the
# composer's YCB candidates kept to the 64-vert ones (a padded hull sinks
# and spins)
_LOCAL_MESH = "robogym.envs.rearrange.datasets.objects.local_mesh:create"
FAMILY_CONFIGS = {
    "table_setting": ({"stabilize_steps": OLDER_STABILIZE_STEPS}, {}),
    "chessboard": ({"stabilize_steps": OLDER_STABILIZE_STEPS}, {}),
    "mixture": ({"stabilize_steps": OLDER_STABILIZE_STEPS, "object_config": {
        "ycb": {"function": _LOCAL_MESH, "args": {"mesh_dirname": "ycb",
                                                  "mesh_names": YCB_MESHES}},
        "geom": {"function": _LOCAL_MESH, "args": {"mesh_dirname": "geom"}}}},
        {"simulation_params": {"num_objects": 5}}),
    "composer": ({"stabilize_steps": OLDER_STABILIZE_STEPS},
                 {"simulation_params": {"num_objects": 5}, "mesh_names": YCB_MESHES}),
}
# the mesh-family paths driven here
FAMILY = tuple(FAMILY_CONFIGS)
# the kernels-line name of each mesh-family world
FAMILY_AT = {"table_setting": "tableware", "chessboard": "chess", "mixture": "mixture",
             "composer": "composer"}
VISION_STEPS = 2                  # env steps of the locked_dummy_vision_env path
PPO_STEPS = 4                     # train steps of the ppo_train path (the reach env)
PPO_HIDDEN = 256                  # the policy's hidden units
PPO_ROLLOUT_STEPS = 2             # steps of the ppo_train path's rollout with the policy
RATIO_TOL = 1e-5                  # PPO's ratio at the old parameters, against 1
REACH_HELPER_BATCH = 16           # envs of the reach_helper path
REACH_HELPER_OFFSET = 0.02        # rad, each arm joint's target from its reset pose (0.05
                                  # took 15 env steps of 40 substeps; 0.02 takes 11)
REACH_HELPER_STEPS = 40           # env steps the reach_helper path may take
# the rearrange blocks env in joint control mode (robot/composite.py), the
# reach_helper path's env
REACH_HELPER_CONFIG = ({}, {"simulation_params": {"num_objects": 5},
                            "robot_control_params": {"control_mode": "joint"}})
# the real-image locked env at full width: 200-pixel images of the three
# vision cameras, a pool of 16 goals, cameras and lights randomized
LOCKED_REAL_IMAGE_CONFIG = dict(vision_image_size=200, goal_pool_size=16, camera_fovy_radius=2.0,
                                camera_pos_radius=0.01, camera_quat_radius=0.05,
                                light_pos_range=0.3, reset_initial_steps=OLDER_INITIAL_STEPS)
REAL_IMAGE_STEPS = 1              # env steps of the locked_real_image_env path
# the blocks env with vision (200-pixel front and wrist cameras), vision
# randomization, every stand-in material, block goal rotations and the
# icp rotational distance
REARRANGE_VISION_CONFIG = (
    {"vision": True, "stabilize_steps": OLDER_STABILIZE_STEPS,
     "goal_args": {"randomize_goal_rot": True, "rot_randomize_type": "block",
                                   "rot_dist_type": "icp"}},
    {"simulation_params": {"num_objects": 5, "camera_fovy_radius": 2.0,
                           "camera_pos_radius": 0.01, "camera_quat_radius": 0.05,
                           "light_pos_range": 0.3},
     "material_names": ("all",)})
REARRANGE_VISION_STEPS = 1        # env steps of the rearrange_vision_env path
EFFORT_TOL = 1e-5                 # actuator_effort against its command after an effort substep
# the randomized reach env's ADR values (paths of its EnvRandomization)
REACH_ADR = (("sim:gravity:value", 0.3), ("sim:jnt_margin:value", 0.2),
             ("sim:geom_solref:timeconst_std", 0.2), ("sim:geom_solref:dampratio_std", 0.2),
             ("sim:dof_damping:mean", 0.1), ("sim:dof_damping:std", 0.3),
             ("sim:geom_friction:std", 0.3))
SEED = 0
REPS = 10                         # launches per kernel timing
HOLD_CYCLES_PER_REP = 2_000_000   # device cycles held per timed launch while the host queues them
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12           # H100 SXM data sheet, float32 outside the tensor cores
CG_EARLY_TOL = 1e-4               # a CG kernel vs plain after 1 and 2 iterations, relative
NOISE_RATIO = 2                   # a CG kernel's float32 error vs the plain version's, both vs float64
                                  # (reported, not held: the one-step check holds)
# A float32 tie of a CG solve's discrete choices (`tie_masks`): two
# line-search costs within TIE_ULPS x 2^-23 of the magnitudes summed into
# each (pen(0), pen(a), |a c1|, a^2 c2 / 2), or a row's jar at a state's
# edge within as much of the magnitudes summed into it; fixed before any
# sweep (PERF.md, PR 21)
TIE_ULPS = 4
F32_EPS = 2.0 ** -23
MAX_FORCED = 4                    # forced choices an env of the CG check may take
MAX_TRIES = 64                    # ties of an env tried at one departure, the latest first
CANDIDATE_CHUNK = 2048            # forced plain runs batched at once in the CG check
EARLY_ITERATIONS = (1, 2)         # the CG check's early iterations (CG_EARLY_TOL)
SPD_TOL = 1e-5                    # A vs plain, relative to the plain version's largest entry
SPD_COLUMN_RATIO = 4              # A's worst per-column error vs float64 over the plain version's
NEAR_TIE_TOL = 5e-3               # witness check of a hull pair on a bf16 near-tie (m)
SAT_TIE_TOL = 1e-6                # box-box: plain SAT depth along the kernel's axis vs its own (m)
_TPU = "robogym_tpu/physics/"
# Every kernel: the module of its wrapper (named as the kernel; its plain
# version is `<name>_plain` beside it), its source in robogym_torch/csrc/,
# the TPU kernel it replaces, and for a CG kernel the outputs its check
# compares.
KERNELS = {
    "cg_full": dict(module="robogym_torch.physics.cg_kernel", source="cg_full.cu",
                    replaces=_TPU + "cg_kernel.py:320 _cg_full_kernel",
                    outputs=("qacc", "efc_force", "qfrc", "qvel_new", "qacc_smooth")),
    "cg_full_noeuler": dict(module="robogym_torch.physics.cg_kernel", source="cg_full.cu",
                            replaces=_TPU + "cg_kernel.py:320 _cg_full_kernel (with_euler=False)",
                            outputs=("qacc", "efc_force", "qfrc")),
    "spd_inverse": dict(module="robogym_torch.physics.factor_kernel", source="spd_inverse.cu",
                        replaces=_TPU + "factor_kernel.py:37 _spd_inverse_kernel"),
    "hull_manifold": dict(module="robogym_torch.physics.collision.convex_kernel",
                          source="hull_sweep.cu",
                          replaces=_TPU + "collision/convex_kernel.py:240 _manifold_kernel_loc"),
    "hull_pair": dict(module="robogym_torch.physics.collision.convex_kernel",
                      source="hull_sweep.cu",
                      replaces=_TPU + "collision/convex_kernel.py:215 _hull_kernel_loc"),
    "hull_manifold_world": dict(module="robogym_torch.physics.collision.convex_kernel",
                                source="hull_sweep.cu",
                                replaces=_TPU + "collision/convex_kernel.py:234 _manifold_kernel"),
    "hull_pair_world": dict(module="robogym_torch.physics.collision.convex_kernel",
                            source="hull_sweep.cu",
                            replaces=_TPU + "collision/convex_kernel.py:202 _hull_kernel"),
    "boxbox": dict(module="robogym_torch.physics.collision.boxbox_kernel", source="boxbox.cu",
                   replaces=_TPU + "collision/boxbox_kernel.py:47 _boxbox_kernel"),
    "cg": dict(module="robogym_torch.physics.cg_kernel", source="cg.cu",
               replaces=_TPU + "cg_kernel.py:93 _cg_kernel", outputs=("qacc", "efc_force")),
}
# launches per substep (per call for forward) of each path; kernels not named launch 0 times
PER_CALL = {
    "locked_like": {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 1, "hull_pair": 1},
    "settle": {"boxbox": 1, "spd_inverse": 2, "cg_full": 1},
    "hand": {"cg": 1, "spd_inverse": 2},
    "forward": {"spd_inverse": 1, "cg_full_noeuler": 1, "hull_manifold": 1, "hull_pair": 1},
    "table_setting": {"hull_manifold": 2, "spd_inverse": 2, "cg_full": 1},
    "hull_world": {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 1, "hull_pair": 1,
                   "hull_manifold_world": 1, "hull_pair_world": 1},
    "locked_env": {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 1, "hull_pair": 1,
                   "boxbox": 1},
}
PER_CALL["wrapped_env"] = dict(PER_CALL["locked_env"])
# the locked env on the world its builder composes from the stand-in asset
# tree: the locked env's launches a substep
PER_CALL["composed_locked_env"] = dict(PER_CALL["locked_env"])
# per env step of the rearrange env: 40 main substeps (2 A, 1 B, 1 C, 1 D,
# 1 E each: the blocks against the table and each other are box-box), one
# fwd_position of the solver sim (its collision: 1 C, 1 D) and its 40
# substeps (2 A, 1 B, 1 C, 1 D each; no box-box pair, no block)
PER_CALL["rearrange_env"] = {"spd_inverse": 2 * 40 + 2 * 40, "cg_full": 40 + 40,
                             "hull_manifold": 40 + 1 + 40, "hull_pair": 40 + 1 + 40,
                             "boxbox": 40}
# per env step of blocks_train: the rearrange env's, and each env's goal
# resample settled for GOAL_SETTLE_SUBSTEPS substeps in the objects-only
# settle world (2 A, 1 B, 1 E each: its blocks against the table and each
# other)
PER_CALL["blocks_train_env"] = {k: PER_CALL["rearrange_env"].get(k, 0)
                                + GOAL_SETTLE_SUBSTEPS * PER_CALL["settle"].get(k, 0)
                                for k in set(PER_CALL["rearrange_env"]) | set(PER_CALL["settle"])}
# dominos: the rearrange env's world with domino-shaped blocks, the same calls
PER_CALL["dominos_env"] = dict(PER_CALL["rearrange_env"])
# the path that steps the world named after `@` in a kernels-line entry
AT_PATH = {"table": "table_setting", "table-box": "table_setting", "dactyl": "locked_env",
           "dt": "wrapped_env", "rearrange": "rearrange_env", "solver": "rearrange_env",
           "settle8": "blocks_train_env", "dominos": "dominos_env",
           "composed": "composed_locked_env"}
# the face-perpendicular env on the cubelet world: the locked env's
# launches a substep (2 A, 1 B; C on the cubelets' and the palm's box-mesh
# pairs, D on the hand's mesh-mesh pairs, E on the palm's box-box pairs
# with the cubelets; the floor's pairs launch none)
PER_CALL["face_env"] = dict(PER_CALL["locked_env"])
PER_CALL["wrapped_face_env"] = dict(PER_CALL["locked_env"])
AT_PATH["face"] = "face_env"
# the full-perpendicular env on the 20-cubelet world: the locked env's
# launches a substep (2 A; its solve in B, or where `cg_kernel.fits` says
# no, in F on the size route, which `main` sets from the captured system;
# C on the pieces' and the palm's box-mesh pairs, D on the hand's mesh-mesh
# pairs, E on the palm's box-box pairs with the pieces)
PER_CALL["full_env"] = dict(PER_CALL["locked_env"])
PER_CALL["wrapped_full_env"] = dict(PER_CALL["locked_env"])
AT_PATH["full"] = "full_env"
# the reach env on its stand-in world (the hand alone): per substep 2 A,
# 1 B, C on the palm's box-mesh pairs with the fingers, D on the fingers'
# mesh-mesh pairs (the floor's pairs launch none); a goal sim launches the
# same per substep, on the envs that resample (`drive`'s calls count them)
PER_CALL["reach_env"] = {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 1, "hull_pair": 1}
PER_CALL["randomized_reach_env"] = dict(PER_CALL["reach_env"])
AT_PATH["reach"] = "reach_env"
# the locked env with dummy vision: the locked env's launches a substep
PER_CALL["locked_dummy_vision_env"] = dict(PER_CALL["locked_env"])
# the YCB env on its stand-in world: a main substep launches 2 A, 1 B, 2 C
# (the table's box-mesh group, and the mesh-mesh group of the objects with
# each other and with the arm's and gripper's links, each env's own
# hulls) and 1 D (the fingers); the solver sim as the rearrange env's; no
# E: the world has no box-box pair. A goal settle's substep is a main one.
PER_CALL["ycb_main"] = {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 2, "hull_pair": 1}
PER_CALL["ycb_env"] = {"spd_inverse": 2 * 40 + 2 * 40, "cg_full": 40 + 40,
                       "hull_manifold": 2 * 40 + 1 + 40, "hull_pair": 40 + 1 + 40}
AT_PATH["ycb"] = "ycb_env"
# under stabilize_goal, a step in which any env resamples adds one goal
# settle: GOAL_SETTLE_SUBSTEPS main substeps on the gathered resampling envs
PER_CALL["ycb_stabilized_env"] = {k: v + GOAL_SETTLE_SUBSTEPS * PER_CALL["ycb_main"][k]
                                  for k, v in PER_CALL["ycb_env"].items()}
# the stand-in holdout: a main substep launches 2 A, 1 B, 1 C (the table
# against the links), 1 D (the platform against the links, the fingers);
# its round-geom groups launch no kernel; the solver sim as above
PER_CALL["holdout_env"] = {"spd_inverse": 2 * 40 + 2 * 40, "cg_full": 40 + 40,
                           "hull_manifold": 40 + 1 + 40, "hull_pair": 40 + 1 + 40}
AT_PATH["holdout"] = "holdout_env"
# the training path on the reach env: its env steps' and goal sims'
# substeps, the reach env's launches each
PER_CALL["ppo_train"] = dict(PER_CALL["reach_env"])
# the rearrange env in joint mode (no solver sim): per env step 40 main
# substeps of 2 A, 1 B, 1 C, 1 D, 1 E
PER_CALL["reach_helper"] = {"spd_inverse": 80, "cg_full": 40, "hull_manifold": 40,
                            "hull_pair": 40, "boxbox": 40}
# paths beside AT_PATH's that step the world an `@` entry names: their
# launches count at that entry
ALSO_AT = {"ppo_train": "reach", "reach_helper": "rearrange"}
# the locked-like world under the Newton solve: a substep's forward_tail
# (1 A: M^-1 for qacc_smooth, which the Newton gradient M (x - qacc_smooth)
# reads; the solve itself needs no M^-1 and runs in plain PyTorch, a batched
# Cholesky) and euler (1 A), C and D on the hand's hulls; no B, no E
PER_CALL["newton_step"] = {"spd_inverse": 2, "hull_manifold": 1, "hull_pair": 1}
AT_PATH["newton"] = "newton_step"
# the real-image locked env: the locked env's launches a substep (its goal
# images come from the pool: no render poses a goal)
PER_CALL["locked_real_image_env"] = dict(PER_CALL["locked_env"])
# the blocks env with vision: the rearrange env's launches an env step, and
# the goal image's fwd_position of the main sim in each observation (its
# collision: 1 C, 1 D, 1 E)
PER_CALL["rearrange_vision_env"] = {k: v + (k in ("hull_manifold", "hull_pair", "boxbox"))
                                    for k, v in PER_CALL["rearrange_env"].items()}
# the mesh-family envs driven here: the YCB env's launches an env step (their
# worlds have its groups: box-mesh, mesh-mesh of free bodies, the fingers,
# plane-mesh); `main` moves the composer's B launches to F where
# `cg_kernel.fits` sends its system there
for _name in FAMILY:
    PER_CALL[_name + "_env"] = dict(PER_CALL["ycb_env"])
    AT_PATH[FAMILY_AT[_name]] = AT_PATH[FAMILY_AT[_name] + "-box"] = _name + "_env"
AT_PATH["ycb-box"] = "ycb_env"
# fields the default stack overrides that the dactyl-shaped world leaves
# equal across envs, and why
WRAPPED_SAME = {"body_pos": "no cube:top or cube:bottom body for the cube-size scale",
                "tendon_range": "its tendons have no range (width 0) to widen"}
# the same for the face stack on the cubelet world
FACE_WRAPPED_SAME = dict(WRAPPED_SAME, geom_size="no cube:middle, cube:top or cube:bottom geom "
                         "for the cube-size scale (its cubelets are cube:cubelet:*)")
# the same for the full stack on the 20-cubelet world (its perpendicular
# cube-size scale does reach geom_size, on the pieces)
FULL_WRAPPED_SAME = dict(WRAPPED_SAME, body_pos="no cube:top or cube:bottom body, and the "
                         "pieces' bodies at the cube's origin, which the perpendicular scale "
                         "leaves there")
# the env-step envelope of the port's CPU tests (tests/_torch_common.py):
# cube position (m), qpos, qvel
ENVELOPE = (("cube position", "qpos", 2e-4), ("qpos", "qpos", 1e-3), ("qvel", "qvel", 5e-2))
NUDGE = 1e-6                      # the nudged runs' perturbation of every start qvel
NUDGE_RATIO = 2                   # drift from the reference over the largest nudged drift
NUDGED_RUNS = 8                   # nudged runs of the face agreement (tests/test_torch_face.py)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after two warm-up calls.
    The device first spins for about 1 ms a call (`torch.cuda._sleep`)
    while the host queues the calls behind it, so the events time the
    device running them back to back, not the host's launch rate (a hull
    wrapper's Python takes longer than its kernel, and a CG wrapper's
    outlasted a 0.2 ms hold on a busy host)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES_PER_REP * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host time of one call of `fn` (its Python and launch), in us,
    over `reps` calls that queue without a wait."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def wrapper(name: str, plain: bool = False):
    """Kernel `name`'s wrapper, or its plain version."""
    module = importlib.import_module(KERNELS[name]["module"])
    return getattr(module, name + "_plain" if plain else name)


@contextlib.contextmanager
def patched(subs):
    """Set `module.<name>` to `fn` for each ((module, name), fn) of `subs`
    while inside."""
    orig = [(module, name, getattr(module, name)) for (module, name), _ in subs]
    try:
        for (module, name), fn in subs:
            setattr(module, name, fn)
        yield
    finally:
        for module, name, fn in orig:
            setattr(module, name, fn)


def recording(module, names, store):
    """Record the arguments of `module.<name>` calls (tensors cloned) into
    store[name], the last call's kept."""
    def recorder(name, fn):
        def rec(*args):
            store[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            return fn(*args)
        return rec

    return patched([((module, n), recorder(n, getattr(module, n))) for n in names])


def plain_versions():
    """Route the paths through every kernel's plain version."""
    return patched([((importlib.import_module(k["module"]), name), wrapper(name, plain=True))
                    for name, k in KERNELS.items()])


def _same_arrays(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def _settle_file(directory, label):
    return os.path.join(directory, label.replace(" ", "_") + ".npz")


def _prefixed(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


class SettleMemo:
    """The B=1 settles of the env constructions, each run once: inside
    `construction`, a `step.step_n` call on a batch of one env whose
    model, start state and substep count equal, field by field, those of
    a settle already run takes a copy of that settle's result instead of
    running again (constructions of one env class on one world share their
    settle; so do classes whose settle reads the same model and start).

    The settles of the other worlds run ahead in a second process
    (`start_prefetch`: this script with `--settles DIR`, the constructions
    of `prefetch_constructions` one after another), which writes each
    settle's model, start state, substep count and result into DIR
    (`publish`); a construction here that finds no equal settle of its own
    takes the one its label names there when model, start and substeps are
    equal field by field (waiting for it while that process runs, at most
    PREFETCH_WAIT_S), and else runs its own. The host paces a B=1 settle,
    so the two processes overlap. Prints each construction's seconds and
    where its settle came from."""

    def __init__(self):
        self.entries = []                 # (label, model, start, substeps, result)
        self.seconds = {}
        self.active = None                # (label, notes) of the construction running
        self.publish = None               # the directory a prefetch process writes into
        self.source = None                # (directory, process, labels) of a prefetch
        self.directory = None             # the prefetch's directory, removed by `close`

    def _prefetched(self, label, n, m_arr, d_arr, device):
        """The prefetch process's settle for `label`, where its inputs
        equal these: (Data on `device`, seconds waited, seconds it ran
        there), or None."""
        from robogym_torch import bridge

        if self.source is None or label not in self.source[2]:
            return None
        directory, proc, _ = self.source
        path = _settle_file(directory, label)
        t0 = time.perf_counter()
        while (not os.path.exists(path) and proc.poll() is None
               and time.perf_counter() - t0 < PREFETCH_WAIT_S):
            time.sleep(0.05)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        if int(arrays["n"]) != n or not (_same_arrays(_prefixed(arrays, "M:"), m_arr)
                                         and _same_arrays(_prefixed(arrays, "S:"), d_arr)):
            return None
        return (bridge.data_from_numpy(_prefixed(arrays, "R:"), device),
                time.perf_counter() - t0, float(arrays["seconds"]))

    def _write(self, label, n, m_arr, d_arr, out, seconds):
        from robogym_torch import bridge

        path = _settle_file(self.publish, label)
        tmp = path[:-4] + ".tmp.npz"
        np.savez(tmp, n=np.asarray(n), seconds=np.asarray(seconds),
                 **{"M:" + k: v for k, v in m_arr.items()},
                 **{"S:" + k: v for k, v in d_arr.items()},
                 **{"R:" + k: v for k, v in bridge.data_to_numpy(out).items()})
        os.replace(tmp, path)

    def _step_n(self, orig):
        from robogym_torch import bridge
        from robogym_torch.envs import core

        def step_n(m, d, n):
            if self.active is None or d.qpos.shape[0] != 1:
                return orig(m, d, n)
            label, notes = self.active
            m_arr, d_arr = bridge.model_to_numpy(m), bridge.data_to_numpy(d)
            for owner, m0, d0, n0, out in self.entries:
                if n0 == n and _same_arrays(m0, m_arr) and _same_arrays(d0, d_arr):
                    notes.append(f"{n} substeps shared with the {owner}")
                    return core.data_map(torch.clone, out)
            got = self._prefetched(label, n, m_arr, d_arr, d.qpos.device)
            if got is not None:
                out, waited, ran = got
                notes.append(f"{n} substeps from the prefetch process (run there in {ran:.2f} "
                             f"s; waited {waited:.2f} s)")
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(m, d, n)
                torch.cuda.synchronize()
                ran = time.perf_counter() - t0
                notes.append(f"{n} substeps run in {ran:.2f} s")
                if self.publish:
                    self._write(label, n, m_arr, d_arr, out, ran)
            self.entries.append((label, m_arr, d_arr, n, core.data_map(torch.clone, out)))
            return out
        return step_n

    def start_prefetch(self):
        """Start the prefetch process (this script with `--settles DIR`, DIR
        a new temporary directory), its output into DIR/prefetch.log."""
        labels = [label for label, _ in prefetch_constructions()]
        directory = self.directory = tempfile.mkdtemp(prefix="chip_smoke_settles_")
        log = open(os.path.join(directory, "prefetch.log"), "w")
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--settles",
                                 directory], stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        log.close()
        self.source = (directory, proc, labels)

    def stop_prefetch(self):
        """Wait for the prefetch process (at most PREFETCH_WAIT_S; then end
        it), print its log and drop it."""
        if self.source is None:
            return
        directory, proc, _ = self.source
        try:
            rc = proc.wait(timeout=PREFETCH_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        with open(os.path.join(directory, "prefetch.log")) as f:
            for line in f:
                print("[prefetch] " + line.rstrip())
        print(f"[prefetch] the process ended with code {rc}")
        self.source = None

    def close(self):
        """End the prefetch process if it runs, and remove its directory."""
        if self.source is not None:
            self.source[1].kill()
            self.source[1].wait()
            self.source = None
        if self.directory:
            shutil.rmtree(self.directory, ignore_errors=True)

    @contextlib.contextmanager
    def construction(self, label):
        from robogym_torch.physics import step

        notes = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.active = (label, notes)
        try:
            with patched([((step, "step_n"), self._step_n(step.step_n))]):
                yield
            torch.cuda.synchronize()
        finally:
            self.active = None
        self.seconds[label] = time.perf_counter() - t0
        print(f"[construction] {label}: {self.seconds[label]:.2f} s; its B=1 settle: "
              f"{'; '.join(notes) or 'none'}", flush=True)


MEMO = SettleMemo()


def prefetch_constructions():
    """(label, build) of the constructions whose B=1 settles the prefetch
    process runs, in the order the state phase builds them, each as the
    state phase builds it (on the committed snapshots where the state
    phase takes the port's compiles: the same arrays)."""
    from robogym_torch import bridge
    from robogym_torch.envs.dactyl import face_perpendicular, full_perpendicular, locked
    from robogym_torch.envs.dactyl import locked_real_image, reach
    from robogym_torch.utils import env_utils
    from robogym_torch.worlds import compile as world_compile
    from robogym_torch.worlds import holdout_ball_like

    def rearrange(module, config):
        return lambda: importlib.import_module("robogym_torch.envs.rearrange." + module).make_env(
            *config, device="cuda", seed=SEED)

    def composed():
        with np.load(world_compile.snapshot_path("dactyl_locked_composed")) as z:
            model = bridge.model_from_numpy({k: z[k] for k in z.files}, "cuda")
        return locked.make_env(device="cuda", seed=SEED, model=model)

    return ([("locked env", lambda: locked.make_env(device="cuda", seed=SEED)),
             ("composed locked env", composed),
             ("face env", lambda: face_perpendicular.make_env(device="cuda", seed=SEED)),
             ("full env", lambda: full_perpendicular.make_env(device="cuda", seed=SEED)),
             ("rearrange blocks env", rearrange("blocks", REARRANGE_CONFIG)),
             ("dominos env", rearrange("dominos", DOMINOS_CONFIG)),
             ("reach env", lambda: reach.make_env(device="cuda", seed=SEED)),
             ("real-image env", lambda: locked_real_image.make_env(
                 LOCKED_REAL_IMAGE_CONFIG, device="cuda", seed=SEED)),
             ("rearrange vision env", rearrange("blocks", REARRANGE_VISION_CONFIG)),
             ("YCB env", rearrange("ycb", YCB_CONFIG)),
             ("holdout env", lambda: env_utils.load_env(
                 holdout_ball_like.CONFIG, constants={"stabilize_steps": OLDER_STABILIZE_STEPS},
                 device="cuda", seed=SEED))]
            + [(f"{name} env", rearrange(name, FAMILY_CONFIGS[name])) for name in FAMILY])


def prefetch_settles(directory) -> int:
    """The prefetch process (`--settles DIR`): each construction of
    `prefetch_constructions` with its B=1 settle written into DIR."""
    from robogym_torch import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.build()
    MEMO.publish = directory
    for label, build in prefetch_constructions():
        with MEMO.construction(label):
            build()
    return 0


def constructing(module, name, label):
    """`module.<name>` (an env factory) patched to build inside
    `MEMO.construction(label)`, recording the env it returns in the
    yielded dict: for entry points that build their env themselves."""
    made = {}
    fn = getattr(module, name)

    def build(*args, **kwargs):
        with MEMO.construction(label):
            made["env"] = fn(*args, **kwargs)
        return made["env"]

    @contextlib.contextmanager
    def ctx():
        with patched([((module, name), build)]):
            yield made

    return ctx()


def cg_flops(E: int, V: int, iterations: int, build: int = 0, aref: bool = True,
             qs: bool = False, qfrc: bool = True, euler: bool = False) -> float:
    """Operations of a CG solve: building J (`build`), aref (2 per entry of
    J), qacc_smooth (a (V, V) matvec), jar, the first gradient and its
    preconditioned step (two J and two (V, V) passes, 20 per row), per
    iteration J p, J^T f, three (V, V) matvecs, about 100 per row of
    forces, costs and line search and 20 per dof, then J^T f and the four
    (V, V) matvecs of the Euler update."""
    n = build + (2 * E * V if aref else 0) + (2 * V * V if qs else 0) + 4 * E * V + 4 * V * V
    n += 20 * E + iterations * (4 * E * V + 6 * V * V + 100 * E + 20 * V)
    return n + (2 * E * V if qfrc else 0) + (8 * V * V if euler else 0)


def contact_build_flops(S: int, F: int, V: int) -> int:
    """Building the contact rows of J: each contact's relative Jacobian once
    (33 per dof) and its 3 frame projections (15 per dof), then 2 per facet
    entry."""
    return S * V * (33 + 15) + 2 * S * F * V


def hull_flops(K: int, V1: int, V2: int, ndir: int, manifold: bool, world: bool) -> float:
    """Per pair: the world transform (18 a vert, none for world verts) and
    centering (3), 5 per vert and side for each direction's bf16 dot, the
    witness extraction (10 a vert), and for the manifold 4 support bounds on
    side 2 and 26 per side-1 corner."""
    per = (V1 + V2) * ((3 if world else 21) + 5 * ndir + 10)
    if manifold:
        per += 4 * 5 * V2 + 26 * V1
    return K * per


# per box-box pair: 15 SAT depths of 6 dots (5 each) and 9 more (about 50),
# 9 cross axes (20), 16 corner candidates (62 each), the witness (60)
BOXBOX_FLOPS = 15 * 50 + 9 * 20 + 16 * 62 + 60


def column_err(got, ref):
    """The largest over envs and columns of a column's max abs error
    against `ref` over that column's largest entry of `ref`."""
    err = (got.double() - ref).abs().amax(-2)
    return float((err / ref.abs().amax(-2).clamp_min(1e-300)).max())


def spd_readings(A):
    """Kernel A against its plain version on matrices A (B, V, V): the
    relative error against the plain version's largest entry, and column by
    column against a float64 inverse (`column_err`) for the kernel and for
    the plain version. Kernel A factors the matrix that the plain version
    factors (the lower triangle), so the float64 inverse is the plain
    version's on the float64 copy. The kernel's per-column error may be at
    most SPD_COLUMN_RATIO times the plain version's: the global check alone
    cannot see an error in a column whose entries are small beside the
    largest (locked-like M^-1 peaks at about 2e4 on the cube's dofs, the
    hand's block is far below that). Returns (readings, failures)."""
    from robogym_torch.physics import factor_kernel as fk

    got, want = fk.spd_inverse(A), fk.spd_inverse_plain(A)
    ref = fk.spd_inverse_plain(A.double())
    torch.cuda.synchronize()
    r = dict(max_abs_err=float((got - want).abs().max()), max_err=rel_err(got, want),
             column=column_err(got, ref), plain_column=column_err(want, ref),
             ref_max=float(want.abs().max()), symmetric=torch.equal(got, got.transpose(1, 2)))
    failures = []
    if not bool(torch.isfinite(got).all()):
        failures.append("non-finite output")
    if not r["max_err"] <= SPD_TOL:
        failures.append(f"rel err {r['max_err']:.3g} > {SPD_TOL}")
    if not r["column"] <= SPD_COLUMN_RATIO * r["plain_column"]:
        failures.append(f"per-column err {r['column']:.3g} > {SPD_COLUMN_RATIO} x the plain "
                        f"version's {r['plain_column']:.3g}")
    if not r["symmetric"]:
        failures.append("output not bit-symmetric")
    return r, failures


def spd_layout(label, B, V):
    """Print kernel A's layout at V dofs and B envs: its route, warps a
    block, envs an SM and waves. A build that reports no warps a block
    (before the block kernel) ran one warp an env."""
    from robogym_torch import cuda

    lay = cuda.spd_inverse_info(V)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_block = lay["warps_per_block"] if lay["warps_per_block"] > 0 else lay["envs_per_block"]
    envs = lay["blocks_per_sm"] * lay["envs_per_block"]
    check(envs > 0, f"{label}: no block fits on an SM")
    route = lay["route"] or ("registers" if lay["rows_per_lane"] > 0 else
                             "device" if not lay["smem_bytes"] else "shared")
    where = {"registers": f"{lay['rows_per_lane']} row(s) a lane in registers, one warp an env",
             "shared": "the matrix in shared memory, one env a block",
             "device": "the matrix in device memory, one env a block"}[route]
    print(f"[{label}] layout: {where}, {per_block} warps a block, {lay['envs_per_block']} "
          f"env(s) a block, {lay['smem_bytes']} B of shared memory a block, {lay['registers']} "
          f"registers, {lay['blocks_per_sm']} blocks an SM ({envs} envs, "
          f"{lay['blocks_per_sm'] * per_block} warps an SM), {B / (envs * sms):.2f} waves")
    return lay


def dense_spd(B, V, device, seed=SEED):
    """B seeded dense SPD matrices X X^T / V + I (V, V), float32: every
    entry of each factor live. A path's M can leave parts of kernel A's
    arithmetic at zero: the dactyl-shaped world's rows 30-35 (the target's
    slides and ball) are decoupled and diagonal, so there the second slot
    of rows (rows 32 and up) runs no off-diagonal update."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.randn((B, V, V), generator=gen, dtype=torch.float64, device=device)
    eye = torch.eye(V, dtype=torch.float64, device=device)
    return (X @ X.transpose(1, 2) / V + eye).float().contiguous()


def phase_spd(label, A, reps):
    """Kernel A on the matrices A (B, V, V) that one of its paths gave it,
    and on dense seeded SPD matrices of the same shape (`dense_spd`)."""
    from robogym_torch.physics import factor_kernel as fk

    r, failures = spd_readings(A)
    check(not failures, f"spd_inverse: {'; '.join(failures)}")
    B, V, _ = A.shape
    rd, failures = spd_readings(dense_spd(B, V, A.device))
    check(not failures, f"spd_inverse on dense SPD matrices: {'; '.join(failures)}")
    print(f"[{label}] dense seeded SPD matrices, B={B} V={V}: rel err {rd['max_err']:.3g}, "
          f"per-column err vs float64 {rd['column']:.3g}, plain version's "
          f"{rd['plain_column']:.3g}; bit-symmetric")
    lay = spd_layout(label, B, V)
    check(V <= 64 or (lay["warps_per_block"] >= 2 and lay["envs_per_block"] == 1
                      and lay["route"] == ("shared" if V <= lay["max_smem_v"] else "device")),
          f"{label}: above 64 dofs kernel A runs one env a block of warps, the matrix in shared "
          f"memory up to {lay['max_smem_v']} dofs, not {lay}")
    ms = timed_ms(lambda: fk.spd_inverse(A), reps)
    plain_ms = timed_ms(lambda: fk.spd_inverse_plain(A), reps)
    lib_ms = timed_ms(lambda: torch.linalg.inv(A), reps)
    chol_ms = timed_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(A)), reps)
    b_ms, b_by = bound(2 * nbytes(A), B * V ** 3)
    print(f"[{label}] B={B} V={V} rel err {r['max_err']:.3g} (tol {SPD_TOL}, ref |max| "
          f"{r['ref_max']:.4g}); per-column err vs float64 {r['column']:.3g}, plain version's "
          f"{r['plain_column']:.3g} (at most {SPD_COLUMN_RATIO} x); bit-symmetric; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (cholesky_ex, solve_triangular, matmul), "
          f"linalg.inv {lib_ms:.4f} ms, cholesky_inverse {chol_ms:.4f} ms, bound {b_ms:.5f} ms")
    if PARENT:
        parent_readings(label, lambda x: (fk.spd_inverse(x),), (A,), reps)
    return dict(max_abs_err=r["max_abs_err"], max_err=r["max_err"], ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, cholesky_inverse_ms=chol_ms,
                bound_ms=b_ms, bound_by=b_by, tol=SPD_TOL, column_err=r["column"],
                plain_column_err=r["plain_column"])


def to_float64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, dict):
        return {k: to_float64(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_float64(v) for v in x)
    return x


def cg_args(ci, iterations, nfacet):
    """Kernel B's arguments from the fused core's captured inputs, with the
    plain SPD inverses."""
    from robogym_torch.physics import factor_kernel as fk

    Minv, Minv_imp = fk.spd_inverse_plain(ci["qM"]), fk.spd_inverse_plain(ci["Mimp"])
    return (ci["kind"], iterations, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["Mimp"],
            Minv_imp, ci["qvel"], ci["qfrc_smooth"], ci["qacc_prev"], ci["dt"])


def take_envs(x, idx, B):
    """The envs `idx` of a CG kernel's arguments: every tensor whose leading
    axis is the batch's (B), inside dicts, tuples and lists; the rest as is."""
    if isinstance(x, torch.Tensor):
        return x[idx] if x.dim() > 0 and x.shape[0] == B else x
    if isinstance(x, dict):
        return {k: take_envs(v, idx, B) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and any(isinstance(v, (torch.Tensor, dict)) for v in x):
        return type(x)(take_envs(v, idx, B) for v in x)
    return x


def forced_plain(name, args, force=None, trace=None, **solve_kw):
    """CG kernel `name`'s plain version on `args`, its line search and row
    states overridden by `force` (`cg_kernel.Forced`) and traced into
    `trace`, with `cg_kernel.cg_plain`'s other options (`start`,
    `states`) in `solve_kw`."""
    from robogym_torch.physics import cg_kernel

    solve = functools.partial(cg_kernel.cg_plain, trace=trace, force=force, **solve_kw)
    if name == "cg":
        return solve(*args)
    return wrapper(name, plain=True)(*args, solve=solve)


def tie_bound(mag):
    """The float32 rounding bound of a line-search cost whose summed terms
    have magnitude `mag` (`cg_kernel.cg_plain`'s trace): TIE_ULPS x 2^-23 x
    mag."""
    return TIE_ULPS * F32_EPS * mag


def tie_masks(trace, rows):
    """The discrete choices that a float32 tie leaves open in a `cg_plain`
    trace of L envs (`rows`: their Deq, Done, Dfr, floss (L, E)), at every
    traced iteration: (pick (L, k, 5) a line-search candidate, 0 to 3 or 4
    for no step at cost 0, whose cost lies within the two costs'
    `tie_bound`s of the pick's; neg (L, k, E) a row with Done > 0 whose
    jar lies within the rounding of jar (`tie_bound` of the magnitudes
    summed into it) of 0; inside (L, k, E) a row with Dfr > 0 whose |Dfr
    jar| lies within as much of floss), and the traced costs, bounds, jar
    and its bounds for the witnesses."""
    cost = torch.stack([t["dcost"] for t in trace], 1).double()
    cost = torch.cat([cost, torch.zeros_like(cost[..., :1])], -1)              # (L, k, 5)
    bnd = tie_bound(torch.stack([t["mag"] for t in trace], 1).double())
    bnd = torch.cat([bnd, torch.zeros_like(bnd[..., :1])], -1)
    pick = torch.stack([t["pick"] for t in trace], 1)                           # (L, k)
    c_r = torch.gather(cost, -1, pick[..., None])
    b_r = torch.gather(bnd, -1, pick[..., None])
    alt = torch.arange(5, device=cost.device) != pick[..., None]
    ties = alt & ((cost - c_r).abs() <= bnd + b_r)
    jar = torch.stack([t["jar"] for t in trace], 1).double()                    # (L, k, E)
    jmag = torch.stack([t["jmag"] for t in trace], 1).double()
    jb = tie_bound(jmag)
    Deq, Done, Dfr, floss = (r.double()[:, None, :] for r in rows)
    neg = (Done > 0) & (jar.abs() <= jb)
    inside = (Dfr > 0) & (((Dfr * jar).abs() - floss).abs() <= tie_bound(Dfr * jmag + floss))
    return ties, neg, inside, dict(cost=cost, bnd=bnd, pick=pick, jar=jar, jb=jb)


def tie_witness(info, l, j, kind, idx):
    """The witness of one tie of `tie_masks` (env l of the trace, iteration
    j, 1-based): a dict for the check's report."""
    if kind == "pick":
        r = int(info["pick"][l, j - 1])
        c, b = info["cost"][l, j - 1], info["bnd"][l, j - 1]
        return dict(kind="pick", picks=(r, idx), costs=(float(c[r]), float(c[idx])),
                    diff=float((c[idx] - c[r]).abs()), bound=float(b[idx] + b[r]))
    return dict(kind=kind, row=idx, jar=float(info["jar"][l, j - 1, idx]),
                bound=float(info["jb"][l, j - 1, idx]))


def row_weights(name, args):
    """(Deq, Done, Dfr, floss) (B, E) of a CG kernel's system."""
    from robogym_torch.physics import constraint as cl

    if name == "cg":
        return args[2:6]
    maps = args[4]
    D = torch.where(maps["active"] > 0, 1.0 / maps["rcoef"], torch.zeros_like(maps["rcoef"]))
    return (*cl.kind_masked_D(args[0], D), maps["floss"])


def envs_off(got, want, scale):
    """(B,) bool: the envs in which some output of `got` leaves `want` by
    more than CG_EARLY_TOL of that output's largest entry in `scale`."""
    off = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for g, w, s in zip(got, want, scale):
        off |= (g - w).abs().reshape(g.shape[0], -1).amax(-1) > CG_EARLY_TOL * s.abs().max()
    return off


def tie_reference(name, args_of, iterations):
    """The forced plain version of CG kernel `name`: the plain version's
    discrete choices made as the kernel made them wherever a float32 tie
    leaves them open, and only there. For k = 1 to `iterations`, the envs
    whose outputs after k iterations leave the current reference by more
    than CG_EARLY_TOL of the batch's largest entry are taken together: the
    ties of iterations k, k - 1, ..., 1 of each env's reference
    (`tie_masks`, at most MAX_TRIES an env) are tried as one more forced
    choice each, all envs' in one batch, and for each env the first after
    which the kernel's outputs agree with the forced plain version's at
    iteration k to CG_EARLY_TOL is kept. An env may take MAX_FORCED forced
    choices; one that leaves with no such tie is not excused. Returns
    (force, excused, unexcused): `cg_kernel.Forced` over the batch, [(env,
    iteration of the tie, witness)] and [(env, k, why)]."""
    from robogym_torch.physics import cg_kernel

    kern = wrapper(name)
    a = args_of(iterations)
    B = (a[0] if name == "cg" else a[5]).shape[0]
    rows = row_weights(name, a)
    E = rows[0].shape[1]
    dev = rows[0].device
    force = cg_kernel.Forced.free(B, iterations, E, dev)
    forced = torch.zeros(B, dtype=torch.long, device=dev)
    given_up = torch.zeros(B, dtype=torch.bool, device=dev)
    excused, unexcused = [], []
    for k in range(1, iterations + 1):
        ak = args_of(k)
        got = kern(*ak)
        want = forced_plain(name, ak, force)
        off = envs_off(got, want, want) & ~given_up
        over = off & (forced >= MAX_FORCED)
        for env in over.nonzero()[:, 0].tolist():
            unexcused.append((env, k, f"leaves after {MAX_FORCED} forced choices"))
        given_up |= over
        envs = (off & ~over).nonzero()[:, 0]
        if not envs.numel():
            continue
        trace = []
        forced_plain(name, take_envs(ak, envs, B), force.take(envs), trace)
        ties, neg, inside, info = tie_masks(trace, [r[envs] for r in rows])
        # the candidates: iteration k first, back to 1; picks, then rows
        order = []
        host = [m.cpu() for m in (ties, neg, inside)]
        for l in range(envs.numel()):
            c = [(j, kind, int(i)) for j in range(k, 0, -1)
                 for kind, m in zip(("pick", "neg", "inside"), host)
                 for i in m[l, j - 1].nonzero()[:, 0]]
            order.append(c[:MAX_TRIES])
        cand_env = [l for l, c in enumerate(order) for _ in c]
        tried = [t for c in order for t in c]
        chosen = {}
        if tried:
            li = torch.as_tensor(cand_env, device=dev)
            cand = force.take(envs[li])
            for n, (j, kind, i) in enumerate(tried):
                if kind == "pick":
                    cand.pick[n, j - 1] = i
                else:
                    t = cand.flip_neg if kind == "neg" else cand.flip_inside
                    t[n, j - 1, i] = ~t[n, j - 1, i]
            agree = []
            for c0 in range(0, len(tried), CANDIDATE_CHUNK):
                part = slice(c0, c0 + CANDIDATE_CHUNK)
                idx = envs[li[part]]
                outs = forced_plain(name, take_envs(ak, idx, B), cand.take(part))
                agree.append(~envs_off([g[idx] for g in got], outs, want))
            agree = torch.cat(agree).cpu().tolist()
            for n, ok in enumerate(agree):
                if ok and cand_env[n] not in chosen:
                    chosen[cand_env[n]] = n
        for l, env in enumerate(envs.tolist()):
            if l not in chosen:
                unexcused.append((env, k, "leaves with no tie" if not order[l] else
                                  f"leaves; none of its {len(order[l])} ties brings it back"))
                given_up[env] = True
                continue
            n = chosen[l]
            force.pick[env] = cand.pick[n]
            force.flip_neg[env] = cand.flip_neg[n]
            force.flip_inside[env] = cand.flip_inside[n]
            forced[env] += 1
            j, kind, i = tried[n]
            excused.append((env, j, tie_witness(info, l, j, kind, i)))
    return force, excused, unexcused


def witness_text(env, it, w):
    """One excused env's witness, as the CG phases print it."""
    if w["kind"] == "pick":
        return (f"env {env} iteration {it}: picks {w['picks'][0]} / {w['picks'][1]} costs "
                f"{w['costs'][0]:.9g} / {w['costs'][1]:.9g}, diff {w['diff']:.3g} <= bound "
                f"{w['bound']:.3g}")
    return (f"env {env} iteration {it}: row {w['row']} state {w['kind']} at its edge, jar "
            f"{w['jar']:.3g}, bound {w['bound']:.3g}")


def solve_system(name, args, outs):
    """CG kernel `name`'s system as `cg_kernel.cg_plain` takes it, (J, aref,
    Deq, Done, Dfr, floss, M, Minv, qs), from its arguments; for `cg_full`
    qacc_smooth is the kernel's own output (`outs`), which its solve used."""
    from robogym_torch.physics import cg_kernel

    if name == "cg":
        return tuple(args[:9])
    kind, _, nfacet, rows, maps, M, Minv = args[:7]
    qvel, qs = (args[9], outs[4]) if name == "cg_full" else (args[7], args[8])
    return (*cg_kernel.solve_inputs(kind, nfacet, rows, maps, qvel), M, Minv, qs)


def envs_over(got, want, scale, tol=CG_EARLY_TOL):
    """(per-env error (B,), the tolerance): the largest |got - want| of
    each env and `tol` of the largest |scale| in the batch."""
    err = (got - want).abs().reshape(got.shape[0], -1).amax(-1)
    return err, tol * float(scale.abs().max())


def grad_magnitudes(system, x, jar):
    """The magnitudes of the terms summed into g = M (x - qs) + J^T f(jar)
    and into M^-1 g, (B, V) each, for `system` (`solve_system`)."""
    from robogym_torch.physics.smooth import mv

    J, _, Deq, Done, Dfr, floss, M, Minv, qs = system
    neg = (jar < 0).to(jar.dtype)
    f = Deq * jar + Done * jar * neg + torch.minimum(torch.maximum(Dfr * jar, -floss), floss)
    g = mv(M.abs(), (x - qs).abs()) + mv(J.abs().transpose(-1, -2), f.abs())
    return g, mv(Minv.abs(), g)


def plain_beta(tr, k):
    """The plain version's beta of iteration k + 1 on the kernel's own
    traced g and M^-1 g after k and k + 1 iterations (`cg_plain`'s
    expression), and its float32 rounding bound: TIE_ULPS x 2^-23 x the
    magnitudes summed into its two dot products (sum |g'| (|Mg'| + |Mg|)
    and sum |g| |Mg|), carried through the quotient."""
    gn, Mgn, g, Mg = tr["g"][:, k + 1], tr["Mg"][:, k + 1], tr["g"][:, k], tr["Mg"][:, k]
    den = torch.clamp(torch.sum(g * Mg, dim=-1), min=1e-12)
    beta = torch.clamp(torch.sum(gn * (Mgn - Mg), dim=-1) / den, min=0.0)
    m0 = (gn.abs() * (Mgn.abs() + Mg.abs())).sum(-1).double()
    m1 = (g.abs() * Mg.abs()).sum(-1).double()
    b = beta.double().abs()
    return beta, TIE_ULPS * F32_EPS * ((m0 + b * m1) / den.double() + b)


PARENT = {}   # the parent build to compare kernels A, B and F with (`--parent-csrc`)
CG_ENTRIES = ("cg_full", "cg_full_noeuler", "cg")


@contextlib.contextmanager
def build_of(csrc, build_dir):
    """Run the kernel wrappers on the library built from `csrc` (another
    checkout's `robogym_torch/csrc`, built into `build_dir`) while inside.
    Where its CG entry points take no trace pointer (before the trace),
    they are called without it, and only with a null one."""
    from robogym_torch import cuda

    saved = (cuda.CSRC, cuda.BUILD_DIR, cuda._lib, cuda._build_log, dict(cuda.SIGNATURES),
             cuda.launch, cuda._SIZES)
    with open(os.path.join(csrc, "cg_common.cuh")) as f:
        traced = "trace_floats" in f.read()
    cuda.CSRC, cuda.BUILD_DIR, cuda._lib = csrc, build_dir, None
    cuda._size.cache_clear()
    if not traced:
        launch = cuda.launch

        def untraced(name, *args):
            if name in CG_ENTRIES:
                n = cuda.SIGNATURES[name][0]
                check(args[n] is None, f"{csrc}: {name} takes no trace pointer")
                args = args[:n] + args[n + 1:]
            return launch(name, *args)

        for name in CG_ENTRIES:
            n, i = cuda.SIGNATURES[name]
            cuda.SIGNATURES[name] = (n - 1, i)
        cuda.launch = untraced
        cuda._SIZES = tuple(e for e in cuda._SIZES if e[0] != "cg_trace_floats")
    try:
        cuda.build()
        yield
    finally:
        cuda.CSRC, cuda.BUILD_DIR, cuda._lib, cuda._build_log = saved[:4]
        cuda.SIGNATURES.update(saved[4])
        cuda.launch, cuda._SIZES = saved[5:]
        cuda._size.cache_clear()


@contextlib.contextmanager
def unwritten_nan():
    """Within: `torch.empty` and `torch.empty_like` fill the floating
    tensors they return with NaN, so that an output a kernel leaves
    unwritten reads as NaN (never `torch.equal`), not as the bytes a freed
    allocation of an earlier call left there."""
    empty, empty_like = torch.empty, torch.empty_like

    def nan(t):
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = lambda *a, **k: nan(empty(*a, **k))
    torch.empty_like = lambda *a, **k: nan(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def parent_readings(label, fn, args, reps):
    """Kernel wrapper `fn` on `args` (a CG kernel's with its trace pointer
    null), against the parent build (`PARENT`): whether every output is
    `torch.equal`, each build's outputs allocated NaN (`unwritten_nan`),
    and both builds' times in turns (this, parent, parent, this)."""
    with unwritten_nan():
        ours = [o.clone() for o in fn(*args)]
        with build_of(**PARENT):
            same = all(torch.equal(a, b) for a, b in zip(ours, fn(*args)))
    t = []
    for parent in (False, True, True, False):
        with build_of(**PARENT) if parent else contextlib.nullcontext():
            t.append(timed_ms(lambda: fn(*args), reps))
    print(f"[{label}] against the parent build {PARENT['csrc']} (trace pointer null): outputs "
          f"{'torch.equal' if same else 'DIFFER'}; ms in turns (this, parent, parent, this) "
          + " / ".join(f"{x:.4f}" for x in t) + f"; this build's spread "
          f"{abs(t[0] - t[3]):.4f}, parent's {abs(t[1] - t[2]):.4f}, means "
          f"{(t[0] + t[3]) / 2:.4f} / {(t[1] + t[2]) / 2:.4f}")
    check(same, f"{label}: outputs differ from the parent build's")
    return dict(same=same, turns=t)


def one_step_readings(name, args_of, iterations):
    """Kernel `name` held one CG iteration at a time from its own state
    (its trace, `cg_kernel.split_trace`). The set-up (slot 0: x, jar, the
    search direction p, g, M^-1 g) against the plain version's set-up on
    the same inputs; then for k = 0 .. iterations - 1 the plain version run
    one iteration from the kernel's state after k (`cg_plain(start=)`):
    where the two line searches pick differently, the env is excused only
    where the kernel's pick lies within the tie bound of the plain
    version's (`tie_masks`), and the plain step is then forced to the
    kernel's pick; x and jar after k + 1 against that step, each within
    CG_EARLY_TOL of the field's largest entry in the batch, and g and
    M^-1 g within CG_EARLY_TOL of the largest magnitude summed into them
    (`grad_magnitudes`: near convergence g is a small difference of large
    terms, which the step's own float32 rounding moves by more than 1e-4
    of its largest entry); beta against the plain version's beta on the
    kernel's traced g and
    M^-1 g within their rounding bound (`plain_beta`); p after k + 1
    against -M^-1 g + beta p from the kernel's traced values; last the
    kernel's outputs against the plain version's output stage applied to
    its state after `iterations` (`cg_plain(start=)` with no iteration),
    each within CG_EARLY_TOL of its largest entry. The set-up's p, g and
    M^-1 g are held as g and M^-1 g are after a step. A slot that the
    kernel did not write (NaN) fails the check. Returns a dict: "failures",
    "worst" {field: (error over tolerance, step)}, "excused" [(env, step,
    witness)], "outputs" {output: rel err}."""
    from robogym_torch.physics import cg_kernel

    a = args_of(iterations)
    *outs, tr = wrapper(name)(*a, trace=True)
    out = dict(failures=[], worst={}, excused=[], outputs={})
    fails = out["failures"]
    if not all(bool(((g == w) | (g.isnan() & w.isnan())).all())
               for g, w in zip(outs, wrapper(name)(*a))):
        fails.append("one-step: the outputs with the trace differ from those without it")
    fields = cg_kernel.STATE_FIELDS + ("pick", "beta")
    missing = sorted({s for f in fields
                      for s in (~torch.isfinite(tr[f].reshape(*tr[f].shape[:2], -1)))
                      .any(-1).any(0).nonzero()[:, 0].tolist()})
    picks = tr["pick"][:, 1:]
    if missing or not bool(((picks >= 0) & (picks <= 4) & (picks == picks.round())).all()):
        fails.append(f"one-step: the trace is missing or malformed at slots {missing} of "
                     f"{iterations + 1}")
        return out

    def hold(step, field, got, want, scale=None):
        err, tol = envs_over(got, want, want if scale is None else scale)
        worst = float(err.max()) / max(tol, 1e-30)
        if worst > out["worst"].get(field, (-1.0, 0))[0]:
            out["worst"][field] = (worst, step)
        bad = (err > tol).nonzero()[:, 0].tolist()
        if bad:
            fails.append(f"one-step {field} after iteration {step}: envs {bad[:8]}"
                         f"{' ...' if len(bad) > 8 else ''} off by up to {float(err.max()):.3g} "
                         f"> {tol:.3g}")

    setup = []
    forced_plain(name, args_of(0), states=setup)
    system = solve_system(name, a, outs)
    g_mag, Mg_mag = grad_magnitudes(system, setup[0]["x"], setup[0]["jar"])
    for f, scale in zip(cg_kernel.STATE_FIELDS, (None, None, Mg_mag, g_mag, Mg_mag)):
        hold(0, f, tr[f][:, 0], setup[0][f], scale)
    rows = system[2:6]
    B = tr["x"].shape[0]
    envs = torch.arange(B, device=tr["x"].device)
    for k in range(iterations):
        start = {f: tr[f][:, k].contiguous() for f in cg_kernel.STATE_FIELDS}
        states = []
        cg_kernel.cg_plain(*system, None, 1, start=start, states=states)
        kpick = tr["pick"][:, k + 1].long()
        differ = kpick != states[1]["pick"]
        if bool(differ.any()):
            trace = []
            cg_kernel.cg_plain(*system, None, 1, trace=trace, start=start)
            ties, _, _, info = tie_masks(trace, rows)
            tied = differ & ties[envs, 0, kpick]
            for env in (differ & ~tied).nonzero()[:, 0].tolist()[:8]:
                r = int(info["pick"][env, 0])
                fails.append(f"one-step pick at iteration {k + 1}: env {env} picks "
                             f"{int(kpick[env])}, the plain step {r}: costs "
                             f"{float(info['cost'][env, 0, int(kpick[env])]):.9g} / "
                             f"{float(info['cost'][env, 0, r]):.9g}, outside the tie bound "
                             f"{float(info['bnd'][env, 0, r] + info['bnd'][env, 0, int(kpick[env])]):.3g}")
            for env in tied.nonzero()[:, 0].tolist():
                out["excused"].append((env, k + 1, tie_witness(info, env, 1, "pick",
                                                               int(kpick[env]))))
            force = cg_kernel.Forced(torch.where(tied, kpick, -1)[:, None])
            states = []
            cg_kernel.cg_plain(*system, None, 1, force=force, start=start, states=states)
        for f in ("x", "jar"):
            hold(k + 1, f, tr[f][:, k + 1], states[1][f])
        mags = grad_magnitudes(system, states[1]["x"], states[1]["jar"])
        for f, mag in zip(("g", "Mg"), mags):
            hold(k + 1, f, tr[f][:, k + 1], states[1][f], mag)
        beta, bnd = plain_beta(tr, k)
        err = (tr["beta"][:, k + 1].double() - beta.double()).abs()
        ratio = float((err / bnd.clamp_min(1e-300)).max())
        if ratio > out["worst"].get("beta", (-1.0, 0))[0]:
            out["worst"]["beta"] = (ratio, k + 1)
        bad = (err > bnd).nonzero()[:, 0].tolist()
        if bad:
            e = bad[0]
            fails.append(f"one-step beta after iteration {k + 1}: envs {bad[:8]} (env {e}: "
                         f"{float(tr['beta'][e, k + 1]):.9g}, the plain version's "
                         f"{float(beta[e]):.9g}, bound {float(bnd[e]):.3g})")
        hold(k + 1, "p", tr["p"][:, k + 1],
             -tr["Mg"][:, k + 1] + tr["beta"][:, k + 1, None] * tr["p"][:, k])
    final = {f: tr[f][:, iterations].contiguous() for f in cg_kernel.STATE_FIELDS}
    if name == "cg_full":
        final["qs"] = outs[4]
    want = forced_plain(name, args_of(0), start=final)
    for o, g, w in zip(KERNELS[name]["outputs"], outs, want):
        e = out["outputs"][o] = rel_err(g, w)
        if not e <= CG_EARLY_TOL:
            fails.append(f"one-step output stage: {o} rel err {e:.3g} > {CG_EARLY_TOL}")
    return out


def one_step_line(label, r, first=3):
    """Print a CG phase's one-step check: for every field the worst error
    over its tolerance (and the step), the envs excused at a step on a
    pick tie, and the output stage's errors."""
    envs = sorted({e for e, _, _ in r["excused"]})
    print(f"[{label}] one-step check (each iteration from the kernel's own state): worst "
          "error / tolerance " + ", ".join(f"{f} {w:.3g} (step {s})"
                                           for f, (w, s) in r["worst"].items())
          + f"; envs excused on a pick tie at a step: {len(envs)} ({len(r['excused'])} steps)"
          + "".join(f"; {witness_text(*w)}" for w in r["excused"][:first])
          + "; output stage rel err " + ", ".join(f"{o} {e:.3g}" for o, e in r["outputs"].items()))


def cg_readings(name, args_of, iterations, report=None):
    """CG kernel `name` against its forced plain version (`tie_reference`)
    on the same inputs (`args_of(iterations)` gives them). Returns (errs,
    early, noise, failures): the full solve's relative errors kernel vs
    forced plain; the same after 1 and 2 iterations; and per output
    (kernel vs float64, forced plain vs float64), the float64 run being
    the plain version's forced to the same choices. A dict `report` gets
    the excused envs under "excused" ([(env, iteration of the tie,
    witness)]), the forced choices under "force", under "named" and
    "drifting" the envs that leave the forced plain version within and
    after the early iterations with no tie ([(env, iteration, why)]), and
    under "one_step" the one-step check's readings (`one_step_readings`).

    The kernel sums in another order than the plain version, and 15
    unconverged CG iterations with a discrete line search carry float32's
    last-bit noise far into the result (at B=1024 the plain version's qfrc
    differs from a float64 run of it by 5e-2), grown through stiff rows
    with no discrete choice behind it (PERF.md, Findings). So the first two
    iterations, before the noise has grown, are held to CG_EARLY_TOL, and
    every iteration is held from the kernel's own state, which grown noise
    cannot fail (`one_step_readings`). Where the two sums part on a
    discrete choice that a float32 tie leaves open, the reference follows
    the kernel, and only there; an env that leaves it otherwise within the
    early iterations fails the check by name. The full solve's error
    against a float64 run beside the plain version's (at most NOISE_RATIO
    times) is reported, and holds nothing: it failed sound kernels on some
    seeds of every state (PERF.md, Findings)."""
    kern, outputs = wrapper(name), KERNELS[name]["outputs"]
    force, excused, unexcused = tie_reference(name, args_of, iterations)
    # an env that leaves within the early check's iterations with no tie
    # fails by name; later, float32 noise grows through stiff rows without
    # any discrete choice (PERF.md, Findings), and the one-step check holds
    # each iteration
    named = [(env, k, why) for env, k, why in unexcused if k <= EARLY_ITERATIONS[-1]]
    if report is not None:
        report.update(excused=excused, force=force, named=named,
                      drifting=[u for u in unexcused if u[1] > EARLY_ITERATIONS[-1]])
    failures = [f"env {env} after {k} iteration(s): {why} (tie bound {TIE_ULPS} x 2^-23)"
                for env, k, why in named[:8]]
    if len(named) > 8:
        failures.append(f"{len(named) - 8} more envs leave the forced plain version")
    early = {}
    for its in EARLY_ITERATIONS:
        a = args_of(its)
        got, want = kern(*a), forced_plain(name, a, force)
        early[its] = {n: rel_err(g, w) for n, g, w in zip(outputs, got, want)}
        failures += [f"{n} after {its} iteration(s): rel err {e:.3g} > {CG_EARLY_TOL}"
                     for n, e in early[its].items() if not e <= CG_EARLY_TOL]
    a = args_of(iterations)
    got, want = kern(*a), forced_plain(name, a, force)
    exact = forced_plain(name, to_float64(a), force)
    errs, noise = {}, {}
    for out, g, w, x in zip(outputs, got, want, exact):
        if not bool(torch.isfinite(g).all()):
            failures.append(f"non-finite {out}")
        errs[out] = rel_err(g, w)
        noise[out] = (rel_err(g.double(), x), rel_err(w.double(), x))
    step = one_step_readings(name, args_of, iterations)
    failures += step["failures"]
    if report is not None:
        report["one_step"] = step
    torch.cuda.synchronize()
    return errs, early, noise, failures


def noise_verdict(noise) -> str:
    """The noise check's reading (reported, not held): each output's error
    against float64 over NOISE_RATIO times the plain version's."""
    worst = max(noise, key=lambda o: noise[o][0] / max(NOISE_RATIO * noise[o][1] + 1e-6, 1e-30))
    e_k, e_p = noise[worst]
    return (f"noise check (reported, not held) "
            f"{'within' if e_k <= NOISE_RATIO * e_p + 1e-6 else 'OVER'} {NOISE_RATIO} x the "
            f"plain version's error vs float64 (worst {worst}: {e_k:.3g} vs {e_p:.3g})")


def phase_cg(name, label, args_of, iterations, n_bytes_in, flops, reps, hold=True):
    """A CG kernel's phase: `cg_readings`, then the kernel's and the plain
    version's times and the bound. With `hold` False a failed check does
    not stop the phase: its failures go into the result."""
    report = {}
    errs, early, noise, failures = cg_readings(name, args_of, iterations, report)
    excused_line(label, report["excused"], report["drifting"])
    for its, e in early.items():
        print(f"[{label}] after {its} iteration(s), rel err kernel vs plain (tol "
              f"{CG_EARLY_TOL}): " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    print(f"[{label}] after {iterations}, rel err kernel vs plain (kernel vs float64, plain vs "
          "float64): " + ", ".join(f"{k} {errs[k]:.3g} ({noise[k][0]:.3g}, {noise[k][1]:.3g})"
                                   for k in errs) + "; " + noise_verdict(noise))
    one_step_line(label, report["one_step"])
    check(not hold or not failures, f"{name}: " + "; ".join(failures))
    kern, plain = wrapper(name), wrapper(name, plain=True)
    args = args_of(iterations)
    got, want = kern(*args), forced_plain(name, args, report["force"])
    ms = timed_ms(lambda: kern(*args), reps)
    plain_ms = timed_ms(lambda: plain(*args), max(2, reps // 10))
    b_ms, b_by = bound(n_bytes_in + nbytes(*got), flops)
    print(f"[{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    if PARENT:
        parent_readings(label, kern, args, reps)
    return dict(max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                max_err=max(errs.values()), errs=errs, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, failures=failures)


def excused_line(label, witnesses, drifting=(), first=4):
    """Print how many envs a CG check excused on ties, the witnesses of
    the first few, and how many envs drift from the forced plain version
    after the early iterations with no tie."""
    envs = sorted({env for env, _, _ in witnesses})
    print(f"[{label}] envs excused on float32 ties: {len(envs)} ({len(witnesses)} forced "
          f"choices)" + "".join(f"; {witness_text(*w)}" for w in witnesses[:first])
          + f"; envs drifting past {CG_EARLY_TOL} after iteration {EARLY_ITERATIONS[-1]} with "
          f"no tie (held by the one-step check): {len(drifting)}")


def iteration_split(name, label, args_of, iterations, reps):
    """Kernel `name`'s device time at 0, 1 and `iterations` CG iterations on
    the same inputs, which separates its set-up (J, aref, the first
    gradient, J^T f and the Euler update) from its loop."""
    kern = wrapper(name)
    t = {}
    for its in (0, 1, iterations):
        a = args_of(its)
        t[its] = timed_ms(lambda: kern(*a), reps)
    per_it = (t[iterations] - t[0]) / iterations
    print(f"[{label}] kernel at 0 / 1 / {iterations} iterations: "
          + " / ".join(f"{v:.4f}" for v in t.values())
          + f" ms; set-up {t[0]:.4f} ms, {per_it:.5f} ms an iteration")
    return t


def occupancy_line(label, B, per_sm, smem, layout):
    """A CG kernel's envs resident per SM (`per_sm`, by the occupancy
    calculator), its shared memory per env and the waves that B envs take
    on this card, after `layout` (its shapes and where its arrays live)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(per_sm > 0, f"{label}: no env fits on an SM")
    print(f"[{label}] B={B} {layout}: one warp per env, smem/env {smem} B, {per_sm} envs/SM x "
          f"{sms} SMs = {per_sm * sms} resident, {B / (per_sm * sms):.2f} waves at B={B}")


def b_occupancy(label, B, E, V, S, nfacet, euler):
    """Kernel B's `occupancy_line` at E rows, V dofs, S contacts."""
    from robogym_torch import cuda

    occupancy_line(label, B, cuda.cg_full_blocks_per_sm(E, V, euler),
                   cuda.cg_full_smem_bytes(E, V, euler), f"E={E} V={V} S={S} F={nfacet}")


def f_occupancy(label, B, E, V):
    """Kernel F's `occupancy_line` at E rows and V dofs, on its route."""
    from robogym_torch import cuda

    scratch = cuda.cg_scratch_floats(E, V)
    occupancy_line(label, B, cuda.cg_blocks_per_sm(E, V), cuda.cg_smem_bytes(E, V),
                   f"E={E} V={V}, J in {'device' if scratch else 'shared'} memory, scratch/env "
                   f"{4 * scratch} B")


def phase_cg_full(label, ci, iterations, nfacet, reps, hold=True):
    """Kernel B on the fused core's inputs `ci` from one substep of a path
    (`hold` as `phase_cg`'s)."""
    rows = ci["rows"]
    B, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet
    args = cg_args(ci, iterations, nfacet)
    n_in = nbytes(*rows.values(), *ci["maps"].values(), *args[5:12], torch.as_tensor(ci["dt"]))
    n_in += 4 * E
    flops = B * cg_flops(E, V, iterations, build=contact_build_flops(S, nfacet, V), qs=True,
                         euler=True)
    b_occupancy(label, B, E, V, S, nfacet, True)
    r = phase_cg("cg_full", label, lambda its: cg_args(ci, its, nfacet), iterations,
                 n_in, flops, reps, hold)
    iteration_split("cg_full", label, lambda its: cg_args(ci, its, nfacet), iterations, reps)
    return r


def phase_cg_noeuler(si, reps):
    """Kernel B without the Euler update, on the inputs `solve_core` took
    in one forward()."""
    from robogym_torch.physics import constraint_batched

    kind_s, iterations, nfacet, *args = si
    *head, Minv, qs, x0 = args
    ci = constraint_batched.row_inputs(kind_s, nfacet, *head)
    rows = ci["rows"]
    B, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet

    def args_of(its):
        return (ci["kind"], its, nfacet, rows, ci["maps"], ci["qM"], Minv, ci["qvel"], qs, x0)

    n_in = nbytes(*rows.values(), *ci["maps"].values(), ci["qM"], Minv, ci["qvel"], qs, x0)
    n_in += 4 * E
    flops = B * cg_flops(E, V, iterations, build=contact_build_flops(S, nfacet, V))
    b_occupancy("B cg_full_noeuler", B, E, V, S, nfacet, False)
    r = phase_cg("cg_full_noeuler", "B cg_full_noeuler", args_of, iterations, n_in, flops,
                 reps)
    iteration_split("cg_full_noeuler", "B cg_full_noeuler", args_of, iterations, reps)
    return r


def phase_cg_prebuilt(fa, reps):
    """Kernel F on the inputs `cg` took in one hand-world substep."""
    *ins, iterations = fa
    B, E, V = ins[0].shape
    f_occupancy("F cg", B, E, V)
    print(f"[F cg] live rows per env: mean {float((ins[3] > 0).sum(1).float().mean()):.2f}")
    check(bool((ins[3] > 0).any()), "cg: no live row in the captured inputs")
    r = phase_cg("cg", "F cg", lambda its: (*ins, its), iterations, nbytes(*ins),
                 B * cg_flops(E, V, iterations, aref=False, qfrc=False), reps)
    iteration_split("cg", "F cg", lambda its: (*ins, its), iterations, reps)
    return r


def wide_core_inputs(batch, V=96, n_s=8, S=100, nfacet=4, seed=SEED):
    """A seeded synthetic system for the fused core, wider than any world
    (made with numpy): V dofs, E = n_s + S*nfacet rows (by default V=96
    and E=408, past the 384 rows that kernel B takes at V=96), with an
    equality, two friction and five limit rows and S contacts, about four
    in five live, 1 to 10 mm deep. Returns (kind_s, iterations, nfacet,
    numpy args) in `constraint_batched.fused_step_core`'s order."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    kind_s = np.array([0, 2, 2, 1, 1, 1, 1, 1], np.int32)[:n_s]
    X = rng.standard_normal((batch, V, V))
    qM = X @ X.transpose(0, 2, 1) / V + np.eye(V)
    q, _ = np.linalg.qr(rng.standard_normal((batch * S, 3, 3)))
    pos_s = np.where(kind_s == 1, rng.uniform(-0.05, 0.01, (batch, n_s)), 0.0)
    args = [
        rng.standard_normal((batch, n_s, V)) * 0.5,                      # J_s
        pos_s,
        np.tile([0.02, 1.0], (batch, n_s, 1)),                           # solref_s
        np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (batch, n_s, 1)),          # solimp_s
        np.where(kind_s == 2, 0.1, 0.0) * np.ones((batch, n_s)),         # floss_s
        np.where((kind_s != 1) | (pos_s < 0), 1.0, 0.0),                 # active_s
        rng.uniform(0.5, 2.0, n_s),                                      # diagA_s
        rng.standard_normal((batch, S, 3)) * 0.1,                        # pos_c
        q.transpose(0, 2, 1).reshape(batch, S, 3, 3),                    # frame_c
        rng.uniform(-0.01, -0.001, (batch, S)),                          # dist_c
        np.zeros((batch, S)),                                            # margin_c
        np.tile([1.0, 1.0, 0.005, 1e-4, 1e-4], (batch, S, 1)),           # fric_c
        rng.random((batch, S)) < 0.8,                                    # act_c
        np.full((batch, S), 3, np.int32),                                # cd_sel
        rng.uniform(0.5, 2.0, (batch, S)),                               # iw_c
        (rng.random((batch, S, V)) < 0.5).astype(f32),                   # mask1
        (rng.random((batch, S, V)) < 0.5).astype(f32),                   # mask2
        rng.standard_normal((batch, S, 3)) * 0.1,                        # rc1
        rng.standard_normal((batch, S, 3)) * 0.1,                        # rc2
        np.tile([0.02, 1.0], (batch, S, 1)),                             # solref_c
        np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (batch, S, 1)),            # solimp_c
        rng.standard_normal((batch, V, 6)) * 0.3,                        # cdof
        rng.standard_normal((batch, V)),                                 # qvel
        qM,
        rng.standard_normal((batch, V)),                                 # qfrc_smooth
        rng.standard_normal((batch, V)),                                 # qacc_prev
        rng.uniform(0.1, 1.0, (batch, V)),                               # damp
        np.asarray(0.002),                                               # dt
    ]
    args = [a if a.dtype in (np.bool_, np.int32) else a.astype(f32) for a in map(np.asarray, args)]
    return kind_s, 15, nfacet, args


def phase_cg_wide(reps, fitting, device):
    """The size route at B=1024 on `wide_core_inputs` (V=96, E=408): kernel
    B's layout does not fit there, so `cg_full` takes the route through
    kernel F, which runs with J in device memory. Checks that the route is
    taken there (one launch of F, none of B) and on none of the `fitting`
    systems ((E, V) of kernel B with the Euler update and of F that the
    paths run); holds the routed `cg_full` to `cg_full_plain` and F to
    `cg_plain` (`cg_readings`), and times F, on `device`. Returns F's
    entry."""
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel, constraint_batched

    kind_s, its, nfacet, args = wide_core_inputs(BATCH)
    ci = constraint_batched.core_inputs(kind_s, nfacet,
                                        *[torch.as_tensor(a, device=device) for a in args])
    B, n_s, V = ci["rows"]["Js"].shape
    E = n_s + ci["rows"]["off1"].shape[1] * nfacet
    print(f"[cg@wide] B={B} E={E} V={V}: kernel B smem/env {cuda.cg_full_smem_bytes(E, V, True)} B, "
          f"limit {cuda.max_smem_bytes()} B")
    check(not cg_kernel.fits(E, V, True), f"cg@wide: kernel B takes E={E}, V={V}")
    check(cuda.cg_scratch_floats(E, V) > 0, "cg@wide: kernel F keeps J in shared memory")
    for (Eb, Vb), (Ef, Vf) in fitting:
        check(cg_kernel.fits(Eb, Vb, True), f"cg@wide: kernel B does not take E={Eb}, V={Vb}")
        check(cuda.cg_scratch_floats(Ef, Vf) == 0, f"cg@wide: F's route at E={Ef}, V={Vf}")
    r = phase_cg_routed("wide", ci, its, nfacet, reps)
    r["launches"] = r.pop("routed_launches")
    return r, ci["qM"]


def phase_cg_routed(at, ci, its, nfacet, reps):
    """The size route on the fused core's inputs `ci` (a system that
    kernel B does not take): F's layout; one routed `cg_full` call, which
    must launch F once and nothing else, held to `cg_full_plain`
    (`cg_readings`); then F on that system's solve inputs against
    `cg_plain`, timed (`phase_cg`). Returns F's entry, with the routed
    call's launches of F under "routed_launches"."""
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel
    from robogym_torch.physics import factor_kernel as fk

    B, n_s, V = ci["rows"]["Js"].shape
    E = n_s + ci["rows"]["off1"].shape[1] * nfacet
    f_occupancy("cg@" + at, B, E, V)

    def full_args(k):
        return cg_args(ci, k, nfacet)

    torch.cuda.synchronize()
    cuda.reset_launches()
    cg_kernel.cg_full(*full_args(its))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    print(f"[cg@{at}] one routed cg_full call: launches {launches}")
    check(launches["cg"] == 1 and sum(launches.values()) == 1,
          f"cg@{at}: the routed cg_full launched {launches}, want kernel F once")
    report = {}
    errs, early, noise, failures = cg_readings("cg_full", full_args, its, report)
    excused_line(f"cg@{at}", report["excused"], report["drifting"])
    print(f"[cg@{at}] routed cg_full vs cg_full_plain: early {early}; after {its} " + ", ".join(
        f"{k} {errs[k]:.3g} ({noise[k][0]:.3g}, {noise[k][1]:.3g})" for k in errs)
        + "; " + noise_verdict(noise))
    one_step_line(f"cg@{at}", report["one_step"])
    check(not failures, f"cg@{at} routed cg_full: " + "; ".join(failures))

    Minv = fk.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0].contiguous()
    ins = (*cg_kernel.solve_inputs(ci["kind"], nfacet, ci["rows"], ci["maps"], ci["qvel"]),
           ci["qM"], Minv, qs, ci["qacc_prev"])
    r = phase_cg("cg", "F cg@" + at, lambda k: (*ins, k), its, nbytes(*ins),
                 B * cg_flops(E, V, its, aref=False, qfrc=False), reps)
    r["routed_launches"] = launches["cg"]
    return r


def phase_spd_one_call(label, qM, reps):
    """Kernel A on matrices no path gives it (the wide system's M at V=96;
    dense matrices at HUGE_V and DEV_V): `phase_spd`, with its launches
    counted in one call."""
    from robogym_torch import cuda
    from robogym_torch.physics import factor_kernel as fk

    r = phase_spd(label, qM, reps)
    torch.cuda.synchronize()
    cuda.reset_launches()
    fk.spd_inverse(qM)
    torch.cuda.synchronize()
    r["launches"] = cuda.LAUNCHES["spd_inverse"]
    check(r["launches"] == 1 and sum(cuda.LAUNCHES.values()) == 1,
          f"{label}: one call launched {dict(cuda.LAUNCHES)}")
    return r


def boxbox_readings(args, got, want):
    """The box-box kernel's outputs against its plain version's. Returns
    (max abs err where both chose the same axis, pairs on another axis,
    pairs, failures). Where the kernel chose another axis than the plain
    version (a near-tie of the SAT depth), the plain version's depth along
    the kernel's axis must equal its own within SAT_TIE_TOL, and the
    kernel's candidates must equal those the plain version computes for
    that axis (`boxbox_kernel.along`)."""
    from robogym_torch.physics.collision import boxbox_kernel as bb

    failures = []
    n_k, n_p = got[2][:, :, 0], want[2][:, :, 0]
    same = (n_k - n_p).abs().amax(-1) <= 1e-6                        # (B, K)
    ties, total = int((~same).sum()), same.numel()
    if ties > total // 100:
        failures.append(f"{ties} of {total} pairs chose another axis")
    for name, g, w in zip(("dist", "pos", "normal"), got, want):
        if not bool(torch.isfinite(g).all()):
            failures.append(f"non-finite {name}")
    sentinel = (got[0] >= 1e9) != (want[0] >= 1e9)
    if bool(sentinel[same].any()):
        failures.append(f"{int(sentinel[same].sum())} candidates differ in being sentinels")
    live = (want[0] < 1e9) & same[..., None]
    err = max(float((got[0] - want[0]).abs()[live].max()) if bool(live.any()) else 0.0,
              float((got[1] - want[1]).abs()[live].max()) if bool(live.any()) else 0.0,
              float((n_k - n_p).abs()[same].max()) if bool(same.any()) else 0.0)
    if not err <= 1e-5:
        failures.append(f"max abs err {err:.3g} > 1e-5 where the axes agree")
    if ties:
        depth, dist_t, pos_t = bb.along(*args, n_k)
        gap = float((depth + want[0][..., 16]).abs()[~same].max())
        if not gap <= SAT_TIE_TOL:
            failures.append(f"a near-tie's SAT depths differ by {gap:.3g} > {SAT_TIE_TOL}")
        tied = ~same[..., None] & (dist_t < 1e9)
        if bool(((got[0] >= 1e9) != (dist_t >= 1e9))[~same].any()):
            failures.append("a near-tie's candidates differ in being sentinels")
        e_t = max(float((got[0] - dist_t).abs()[tied].max()) if bool(tied.any()) else 0.0,
                  float((got[1] - pos_t).abs()[tied].max()) if bool(tied.any()) else 0.0)
        if not e_t <= 1e-5:
            failures.append(f"a near-tie's candidates differ from the plain version's along "
                            f"the kernel's axis by {e_t:.3g} > 1e-5")
    return err, ties, total, failures


def boxbox_layout(BK, label="E boxbox"):
    """Print the box-box kernel's layout for BK pairs (`layout_line`)."""
    from robogym_torch import cuda

    layout_line(label, cuda.boxbox_info(), BK)


def phase_boxbox(args, reps, label="E boxbox"):
    from robogym_torch.physics.collision import boxbox_kernel as bb

    got, want = bb.boxbox(*args), bb.boxbox_plain(*args)
    torch.cuda.synchronize()
    boxbox_layout(args[0].shape[0] * args[0].shape[1], label)
    err, ties, total, failures = boxbox_readings(args, got, want)
    live = int((want[0] < 0).sum())
    print(f"[{label}] B={args[0].shape[0]} K={args[0].shape[1]}: max abs err {err:.3g} (tol "
          f"1e-5), pairs on another axis {ties}/{total}, penetrating candidates {live}")
    check(not failures, "boxbox: " + "; ".join(failures))
    check(live > 0, "boxbox: no penetrating candidate in the captured inputs")
    ms = timed_ms(lambda: bb.boxbox(*args), reps)
    host = host_us(lambda: bb.boxbox(*args), reps)
    plain_ms = timed_ms(lambda: bb.boxbox_plain(*args), max(2, reps // 10))
    n_out = got[0].numel() + got[1].numel() + got[2][:, :, 0].numel()
    b_ms, b_by = bound(nbytes(*args) + 4 * n_out, total * BOXBOX_FLOPS)
    print(f"[{label}] kernel {ms:.4f} ms (host {host:.1f} us a call), plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, max_err=err, ties=ties, pairs=total, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, tol=1e-5)


def near_tie_failures(name, args, got, n_plain, tied):
    """Where the kernel chose another direction than the plain version, the
    plain version's selection score (bf16 dots) along the kernel's direction
    must equal the score along its own to within one bf16 ulp of the dots;
    for a hull pair the kernel's witness points must also be supports of
    both hulls along its normal, to NEAR_TIE_TOL. Returns the failures."""
    from robogym_torch.physics.collision import convex_kernel as ck

    failures = []
    v1, v2, c1, c2 = (args if name.endswith("_world") else to_world(args))[:4]
    s_k, _ = ck.selection_score(v1, v2, c1, c2, got[2])
    s_p, scale = ck.selection_score(v1, v2, c1, c2, n_plain)
    gap = (s_k - s_p).abs()[tied]
    ulp = (torch.finfo(torch.bfloat16).eps * scale)[tied]
    if not bool((gap <= ulp).all()):
        failures.append(f"a near-tie's selection scores differ by "
                        f"{float((gap - ulp).max()):.3g} more than one bf16 ulp")
    if name.startswith("hull_pair"):
        dist, pos, n, p2 = (x[tied] for x in got)
        p1 = 2.0 * pos - p2
        d1 = torch.einsum("pi,piv->pv", n, v1[tied]).amax(-1)
        d2 = torch.einsum("pi,piv->pv", n, v2[tied]).amin(-1)
        ok = ((-(d1 - d2) - dist).abs() <= NEAR_TIE_TOL) \
            & ((n * p1).sum(-1) >= d1 - NEAR_TIE_TOL) & ((n * p2).sum(-1) <= d2 + NEAR_TIE_TOL)
        if not bool(ok.all()):
            failures.append(f"{int((~ok).sum())} near-tie witnesses are not supports")
    return failures


def hull_readings(name, args, DX):
    """Hull kernel `name` against its plain version on the operands `args`
    (world verts for the `_world` entries): 1e-5 where both chose the same
    direction, at most 1 pair in 100 on a near-tie of the bf16 selection
    (`near_tie_failures`). Returns (outputs, max abs err, near-ties, pairs,
    failures)."""
    from robogym_torch.physics.collision import convex_kernel as ck

    got, want = getattr(ck, name)(*args, DX), getattr(ck, name + "_plain")(*args, DX)
    torch.cuda.synchronize()
    failures = []
    same = (got[2] - want[2]).abs().amax(-1) <= 1e-6                  # (B, K)
    ties, total = int((~same).sum()), same.numel()
    if ties > total // 100:
        failures.append(f"{ties} of {total} pairs chose another direction")
    if ties:
        failures += near_tie_failures(name, args, got, want[2], ~same)
    errs = []
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            failures.append("non-finite output")
        g, w = g[same], w[same]
        live = w.abs() < 1e9
        errs.append(float((g - w).abs()[live].max()) if bool(live.any()) else 0.0)
    err = max(errs)
    if not err <= 1e-5:
        failures.append(f"max abs err {err:.3g} > 1e-5")
    return got, err, ties, total, failures


def world_vs_local(name, loc_args, DX):
    """The world-vertex kernel of `name` on a local call's operands placed by
    `world_from_loc`, against the local kernel's outputs on the same pairs:
    (max abs diff, pair slots whose outputs differ). They must be equal bit
    for bit: each eager operation of `world_from_loc` rounds once, as the
    local kernel's transform does under -fmad=false."""
    from robogym_torch.physics.collision import convex_kernel as ck

    got = getattr(ck, name + "_world")(*to_world(loc_args), DX)
    ref = getattr(ck, name)(*loc_args, DX)
    torch.cuda.synchronize()
    diff = max(float((g - w).abs().max()) for g, w in zip(got, ref))
    off = sum(int((g != w).reshape(g.shape[0], g.shape[1], -1).any(-1).sum())
              for g, w in zip(got, ref))
    return diff, off


HULL_LETTER = {"hull_manifold": "C", "hull_pair": "D", "hull_manifold_world": "H",
               "hull_pair_world": "G"}


def phase_hull(name, args, DX, reps, label=None):
    """A hull kernel's phase: `hull_readings` on the operands that one of
    its paths gave it, then the kernel's and the plain version's times and
    the bound."""
    from robogym_torch import cuda
    from robogym_torch.physics.collision import convex_kernel as ck

    label = label or f"{HULL_LETTER[name]} {name}"
    world = name.endswith("_world")
    got, err, ties, total, failures = hull_readings(name, args, DX)
    check(not failures, f"{name}: " + "; ".join(failures))
    kern, plain = getattr(ck, name), getattr(ck, name + "_plain")
    ms = timed_ms(lambda: kern(*args, DX), reps)
    host = host_us(lambda: kern(*args, DX), reps)
    plain_ms = timed_ms(lambda: plain(*args, DX), max(2, reps // 10))
    B, K, _, V1 = args[0].shape
    V2 = args[1 if world else 3].shape[-1]
    ndir = 12 + 1 + DX + 16
    n_b = nbytes(*args[:-1]) + nbytes(args[-1][:, :, :max(DX, 1)]) + nbytes(*got)
    manifold = name.startswith("hull_manifold")
    b_ms, b_by = bound(n_b, B * hull_flops(K, V1, V2, ndir, manifold, world))
    extra = ""
    if manifold:
        corner = int((got[0][..., :3] < 1e9).any(-1).sum())
        extra = f", pairs with a side-1 vert in the manifold {corner}"
    layout_line(label, cuda.hull_info(name, V1, V2, DX), B * K)
    print(f"[{label}] B={B} K={K} V1={V1} V2={V2} DX={DX} max abs err {err:.3g} (tol 1e-5), "
          f"near-ties {ties}/{total}{extra}; kernel {ms:.4f} ms (host {host:.1f} us a call), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, max_err=err, ties=ties, pairs=total, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, tol=1e-5)


def layout_line(label, lay, BK):
    """Print a kernel's layout `lay` (a `cuda.*_info` dict): lanes a pair
    where it has them, pairs and shared memory a block, registers, warps an
    SM (the occupancy calculator) and the waves that BK pairs take on this
    card."""
    check(lay["blocks_per_sm"] > 0, f"{label}: no block fits on an SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes = f"{lay['lanes_per_pair']} lanes a pair, " if "lanes_per_pair" in lay else ""
    print(f"[{label}] layout: {lanes}{lay['pairs_per_block']} pairs a block of {lay['threads']} "
          f"threads, {lay['smem_bytes']} B of shared memory a block, {lay['registers']} registers, "
          f"{lay['blocks_per_sm'] * lay['threads'] // 32} warps an SM, "
          f"{BK / (lay['pairs_per_block'] * lay['blocks_per_sm'] * sms):.2f} waves")


def to_world(loc_args):
    """A local-vert hull call's operands with each side placed in the world
    by `world_from_loc`: (v1, v2, c1, c2, xd)."""
    from robogym_torch.physics.collision import convex_kernel as ck

    return (ck.world_from_loc(*loc_args[0:3]), ck.world_from_loc(*loc_args[3:6]), *loc_args[6:9])


def phase_world(name, loc_args, DX, reps, label=None):
    """The world-vertex kernel of `name` (G for hull_pair, H for
    hull_manifold) on a local call's operands placed in the world:
    `phase_hull`, then `world_vs_local`, then both kernels timed in turns
    (local, world, world, local) on the same pairs."""
    from robogym_torch.physics.collision import convex_kernel as ck

    wname = name + "_world"
    label = label or f"{HULL_LETTER[wname]} {wname}"
    wargs = to_world(loc_args)
    r = phase_hull(wname, wargs, DX, reps, label)
    diff, off = world_vs_local(name, loc_args, DX)
    check(off == 0, f"{wname}: differs from {name} on {off} pair slots (max {diff:.3g})")
    loc, wor = getattr(ck, name), getattr(ck, wname)
    t = [timed_ms(lambda: loc(*loc_args, DX), reps), timed_ms(lambda: wor(*wargs, DX), reps),
         timed_ms(lambda: wor(*wargs, DX), reps), timed_ms(lambda: loc(*loc_args, DX), reps)]
    a, b = HULL_LETTER[name], HULL_LETTER[wname]
    print(f"[{label}] against {a} on the same pairs: max abs diff {diff:.3g}, outputs differing "
          f"in {off} pair slots; in turns {a} / {b} / {b} / {a}: "
          + " / ".join(f"{x:.4f}" for x in t) + " ms")
    return r


def load_world(snapshot=None):
    """A world's Model on the card and its snapshot arrays (the locked-like
    world by default)."""
    from robogym_torch import bridge
    from robogym_torch.worlds import locked_like

    with np.load(snapshot or locked_like.SNAPSHOT) as z:
        arrays = {k: z[k] for k in z.files}
    return bridge.model_from_numpy(arrays, "cuda"), arrays


# fields that come through `np.linalg.eigh` (a body's principal axes) or
# the order of scipy's hull verts: held by what they mean, not bit for bit
EIGH_FIELDS = ("model.body_iquat", "model.body_inertia")
HULL_FIELDS = ("model.mesh_convex_vert", "model.mesh_convex_center", "model.mesh_face_plane")
COMPILE_TOL = 1e-6                # of the largest entry: inertia tensors, hull verts as sets


def _quat2mat(q):
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    -1).reshape(-1, 3, 3)


def inertia_tensors(arrays):
    """Each body's inertia tensor, (nbody, 3, 3) in float64, rebuilt from
    its principal frame and moments."""
    R = _quat2mat(np.asarray(arrays["model.body_iquat"], np.float64))
    return R @ (np.asarray(arrays["model.body_inertia"], np.float64)[:, :, None]
                * R.transpose(0, 2, 1))


def rows_as_sets_err(got, want, mask):
    """The largest distance from a masked row of one side to the nearest
    masked row of the other, over the meshes (rows of each mesh compared as
    a set), relative to the largest entry."""
    worst = 0.0
    for g, w, m in zip(got, want, mask):
        g, w = g[m > 0].astype(np.float64), w[m > 0].astype(np.float64)
        d = np.linalg.norm(g[:, None] - w[None], axis=-1)
        scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
        worst = max(worst, float(d.min(1).max(initial=0.0)), float(d.min(0).max(initial=0.0))
                    ) / scale if d.size else worst
    return worst


def hold_to_snapshot(name, model, path):
    """Hold the port's compile `model` of world `name` to its committed
    snapshot `path`: the same keys; integer, static and name fields, and
    float fields, exactly; where the card's host rounds `eigh` or orders a
    hull otherwise, the inertia tensors rebuilt from the principal frames
    and the hulls' verts and face planes as sets, within `COMPILE_TOL` of
    their largest entry. Returns the fields that needed that rule."""
    from robogym_torch import bridge

    got = bridge.model_to_numpy(model)
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    check(sorted(got) == sorted(want), f"compile {name}: keys differ {set(got) ^ set(want)}")
    ruled = []
    for k in sorted(want):
        g, w = got[k], want[k]
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"compile {name}: {k} is {g.dtype} {g.shape}, snapshot {w.dtype} {w.shape}")
        if np.array_equal(g, w):
            continue
        check(k in EIGH_FIELDS + HULL_FIELDS, f"compile {name}: {k} differs from the snapshot")
        ruled.append(k)
    if any(k in EIGH_FIELDS for k in ruled):
        ig, iw = inertia_tensors(got), inertia_tensors(want)
        err = np.abs(ig - iw).max((1, 2)) / np.maximum(np.abs(iw).max((1, 2)), 1e-30)
        check(float(err.max()) <= COMPILE_TOL,
              f"compile {name}: inertia tensors differ by {float(err.max()):.3g} of their largest "
              f"entry")
    for k, mask in (("model.mesh_convex_vert", "model.mesh_convex_mask"),
                    ("model.mesh_face_plane", "model.mesh_face_mask")):
        if k in ruled:
            err = rows_as_sets_err(got[k], want[k], want[mask])
            check(err <= COMPILE_TOL, f"compile {name}: {k} as sets differ by {err:.3g}")
    if "model.mesh_convex_center" in ruled:
        c, w = got["model.mesh_convex_center"], want["model.mesh_convex_center"]
        err = float(np.abs(c - w).max()) / max(float(np.abs(w).max()), 1e-30)
        check(err <= COMPILE_TOL, f"compile {name}: hull centres differ by {err:.3g}")
    return ruled


def compile_phase():
    """The port's compile of every stand-in world (`worlds/compile.py`) on
    the card's host, each held to its snapshot (`hold_to_snapshot`):
    ({name: Model on the card}, {name: seconds}, {name: fields ruled})."""
    from robogym_torch.worlds import compile as world_compile

    models, seconds, ruled = {}, {}, {}
    for name in world_compile.WORLDS:
        t0 = time.perf_counter()
        models[name] = world_compile.compile_world(name, "cuda")
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        ruled[name] = hold_to_snapshot(name, models[name], world_compile.snapshot_path(name))
        c = models[name].const
        print(f"[compile] {name}: nq={c.nq} nv={c.nv} ngeom={c.ngeom} nmesh={c.nmesh} in "
              f"{seconds[name]:.2f} s; "
              + (f"held by meaning: {ruled[name]}" if ruled[name] else "every field equal"),
              flush=True)
    print(f"[compile] {len(models)} worlds in {sum(seconds.values()):.2f} s; fields that needed "
          f"the eigh or hull rule: {sorted({k for v in ruled.values() for k in v}) or 'none'}")
    return models, seconds, ruled


def capture_calls(module, name, run):
    """The arguments of every `module.<name>` call while `run()` runs
    (tensors cloned), in order."""
    calls, fn = [], getattr(module, name)

    def rec(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return fn(*args)

    with patched([((module, name), rec)]):
        run()
    check(bool(calls), f"{name} was not called")
    return calls


def capture_call(module, name, run):
    """The arguments of the last `module.<name>` call while `run()` runs."""
    return capture_calls(module, name, run)[-1]


def capture_core(m, d):
    """The fused core's inputs as one substep of `step` from state d gives
    them: (`constraint_batched.core_inputs`, CG iterations, facets per
    contact)."""
    from robogym_torch.physics import constraint_batched, step

    kind_s, iterations, nfacet, *args = capture_call(constraint_batched, "fused_step_core",
                                                     lambda: step.step(m, d))
    return constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet


def start_states(m, arrays, batch, seed, settle, world=None, **kw):
    """Seeded start states of `world` (a module of `robogym_torch.worlds`,
    the locked-like world by default), settled for `settle` substeps."""
    from robogym_torch.mjcf.model import make_data
    from robogym_torch.physics import step
    from robogym_torch.worlds import locked_like

    qpos, ctrl = (world or locked_like).initial_state(arrays, batch, seed, **kw)
    d = make_data(m, batch, torch.as_tensor(qpos, device=m.device))
    d = d.replace(ctrl=torch.as_tensor(ctrl, device=m.device))
    return step.step_n(m, d, settle)


def worlds():
    """{name: (Model on the card, arrays, start-state keywords)} of the
    five worlds."""
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, locked_like,
                                      table_setting_like)

    out = {}
    for name, snap, kw in (("locked_like", locked_like.SNAPSHOT, dict(settle=20)),
                           ("settle", blocks_settle_like.SNAPSHOT,
                            dict(settle=SETTLE_START, world=blocks_settle_like)),
                           ("hand", locked_like.HAND_SNAPSHOT, dict(settle=5, reach=1.1)),
                           ("table", table_setting_like.SNAPSHOT,
                            dict(settle=SETTLE_START, world=table_setting_like)),
                           ("dactyl", dactyl_locked_like.SNAPSHOT,
                            dict(settle=20, world=dactyl_locked_like))):
        m, arrays = load_world(snap)
        out[name] = (m, arrays, kw)
    return out


def locked_env_reset(batch, model, label="locked env",
                     world="the port's compile of the dactyl-shaped world"):
    """The locked env on the card on the compiled `world` `model` (the
    port's own compile, `[compile]`; its construction runs the
    zero-control settle) and its reset state at `batch` envs from seed 0:
    (env, state). Prints the times, the retries and the share of envs with
    the cube on the palm; checks the state finite."""
    from robogym_torch.envs.dactyl import cube_env, locked

    t0 = time.perf_counter()
    with MEMO.construction(label):
        env = locked.LockedEnv(locked.LockedEnvConstants(), model, seed=SEED)
    t1 = time.perf_counter()
    state, obs = env.reset(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    on_palm = float(cube_env.is_on_palm(env.cube, state.physics).float().mean())
    print(f"[state] {label} on {world}: built (its settle, "
          f"{env.constants.reset_initial_steps * env.constants.mujoco_substeps} substeps at B=1) "
          f"in {t1 - t0:.2f} s; LockedEnv.reset at B={batch} in {t2 - t1:.2f} s, "
          f"{env.reset_retries} retries, on the palm {on_palm:.4f}")
    for k in ("qpos", "qvel", "qacc"):
        check(bool(torch.isfinite(getattr(state.physics, k)).all()), f"{label} reset: non-finite {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"{label} reset: non-finite obs {k}")
    return env, state


def locked_env_steps(env, state, out, label="locked_env"):
    """ENV_STEPS of `LockedEnv.step` from `state`, actions uniform in [-1, 1]
    from a seeded generator on the card (bench.py:77-88); checks every obs
    and reward finite, and puts the reward sum, the episodes done and the
    share on the palm into `out`. Returns the last physics state."""
    from robogym_torch.envs.dactyl import cube_env

    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    rewards, done, finite = 0.0, 0, {}
    for _ in range(ENV_STEPS):
        action = torch.rand((state.t.shape[0], env.action_size), generator=gen,
                            device=env.device) * 2.0 - 1.0
        state, obs, reward, dn, _ = env.step(state, action)
        for k, v in dict(obs, reward=reward).items():   # read after the run: no sync here
            ok = torch.isfinite(v).all()
            finite[k] = finite[k] & ok if k in finite else ok
        rewards = rewards + reward.sum(0)
        done = done + dn.sum()
    for k, ok in finite.items():
        check(bool(ok), f"{label} path: non-finite {k}")
    out.update(reward_sum=[float(x) for x in rewards], done=int(done),
               on_palm=float(cube_env.is_on_palm(env.cube, state.physics).float().mean()))
    return state.physics


def wrapped_env_reset(bare, batch):
    """The default dactyl wrapper stack around a copy of the locked env
    `bare` (`apply_dactyl_wrappers(env, randomize=True)`, as bench.py wraps
    the JAX env under BENCH_WRAPPED=1): its construction shared, a
    generator of its own seeded as `make_env` seeds one, so that each path
    draws what a locked env of its own would) and its reset at `batch`
    envs: (wrapped env, state). Prints the time and the share on the palm;
    checks the state and the observations finite."""
    from robogym_torch import wrappers
    from robogym_torch.envs.dactyl import cube_env

    env = copy.copy(bare)
    env.generator = torch.Generator(device=bare.device)
    env.generator.manual_seed(SEED)
    wenv = wrappers.apply_dactyl_wrappers(env, randomize=True)
    t0 = time.perf_counter()
    state, obs = wenv.reset(batch)
    torch.cuda.synchronize()
    on_palm = float(cube_env.is_on_palm(env.cube, state.physics).float().mean())
    print(f"[state] default dactyl wrapper stack ({len(wenv.transforms)} transforms) around the "
          f"locked env: reset at B={batch} in {time.perf_counter() - t0:.2f} s, "
          f"{env.reset_retries} retries, on the palm {on_palm:.4f}, "
          f"{len(state.model_fields)} model fields per env")
    for k in ("qpos", "qvel", "qacc"):
        check(bool(torch.isfinite(getattr(state.physics, k)).all()),
              f"wrapped env reset: non-finite {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"wrapped env reset: non-finite obs {k}")
    return wenv, state


def wrapped_actions(batch, device):
    """A seeded generator of the wrapped env's discrete actions (B, 20),
    uniform over the N_ACTION_BINS bins."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    return lambda: torch.randint(0, N_ACTION_BINS, (batch, 20), generator=gen, device=device)


def wrapped_env_steps(wenv, state, out):
    """ENV_STEPS of the wrapped env from `state` with seeded discrete
    actions; checks every obs and reward finite, and puts the reward sum,
    the episodes done, the share on the palm, each step's timestep field
    and the last state into `out`. Returns the last physics state."""
    from robogym_torch.envs.dactyl import cube_env

    actions = wrapped_actions(state.t.shape[0], wenv.device)
    rewards, done, finite, timesteps = 0.0, 0, {}, []
    for _ in range(ENV_STEPS):
        state, obs, reward, dn, _ = wenv.step(state, actions())
        for k, v in dict(obs, reward=reward).items():   # read after the run: no sync here
            ok = torch.isfinite(v).all()
            finite[k] = finite[k] & ok if k in finite else ok
        rewards = rewards + reward.sum(0)
        done = done + dn.sum()
        timesteps.append(state.model_fields["opt:timestep"])
    for k, ok in finite.items():
        check(bool(ok), f"wrapped_env path: non-finite {k}")
    out.update(reward_sum=[float(x) for x in rewards], done=int(done),
               on_palm=float(cube_env.is_on_palm(wenv.env.cube, state.physics).float().mean()),
               timesteps=timesteps, state=state)
    return state.physics


def check_field_spread(wenv, fields, timesteps, same=WRAPPED_SAME, label="wrapped_env"):
    """Print each overridden model field's spread across envs (the largest
    over its entries of max - min over envs); every field but those of
    `same` must differ across envs, those must equal the compiled model's
    in every env, and the timestep must change at every step. Returns
    {field: spread}."""
    from robogym_torch.wrappers.core import model_field

    spread = {k: float((v.amax(0) - v.amin(0)).max()) for k, v in fields.items()}
    print(f"[path {label}] spread across envs of each model field: " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(spread.items())))
    check(len(fields) == 12, f"{label}: {len(fields)} model fields, want 12")
    for k, v in fields.items():
        if k in same:
            base = model_field(wenv.env.model, k)
            check(bool((v == base).all()), f"{label}: {k} differs from the compiled model's")
            print(f"[path {label}] {k} equal in every env to the compiled model's: "
                  f"{same[k]} on this world")
        else:
            check(spread[k] > 0, f"{label}: {k} equal in every env")
    changed = [not torch.equal(a, b) for a, b in zip(timesteps, timesteps[1:])]
    print(f"[path {label}] opt:timestep changed at {sum(changed)} of {len(changed)} steps; "
          f"last step's range {float(timesteps[-1].min()):.6g} to "
          f"{float(timesteps[-1].max()):.6g} s")
    check(all(changed), f"{label}: the timestep did not change at every step")
    return spread


def capture_wrapped_core(wenv, state):
    """The fused core's inputs of the last substep of one wrapped env step
    from `state` (its per-env timestep among them): (`core_inputs`, CG
    iterations, facets per contact)."""
    from robogym_torch.physics import constraint_batched

    actions = wrapped_actions(state.t.shape[0], wenv.device)
    kind_s, iterations, nfacet, *args = capture_call(constraint_batched, "fused_step_core",
                                                     lambda: wenv.step(state, actions()))
    return constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet


def check_dt_stride(ci, iterations, nfacet):
    """Kernel B with a timestep shared by the batch (stride 0) against the
    same timestep given per env as a (B,) tensor (stride 1): every output
    equal, bit for bit."""
    from robogym_torch.physics import cg_kernel

    dt = torch.as_tensor(ci["dt"], device=ci["qM"].device)
    check(dt.dim() == 0, f"dt stride check: the locked env's dt has shape {tuple(dt.shape)}")
    B = ci["qM"].shape[0]
    shared = cg_kernel.cg_full(*cg_args(ci, iterations, nfacet))
    per_env = cg_kernel.cg_full(*cg_args(dict(ci, dt=dt.expand(B).contiguous()), iterations,
                                         nfacet))
    torch.cuda.synchronize()
    equal = {n: torch.equal(a, b) for n, a, b in zip(KERNELS["cg_full"]["outputs"], shared, per_env)}
    print(f"[B cg_full dt stride] locked env substep, B={B}: one dt (stride 0) vs the same dt "
          f"per env (stride 1), outputs bit-equal: {equal}")
    check(all(equal.values()), f"cg_full: stride 0 and stride 1 outputs differ: {equal}")


def wrapped_agreement(wenv, state, n=64, model=None, label="wrapped_env"):
    """One substep of the wrapped env's physics on its first n envs (each
    env's own model fields, the state of the wrapped path's last step)
    through the kernels, through the plain versions, and through the plain
    versions in float64: the kernels' relative error against float64 at
    most NOISE_RATIO times the plain float32 version's (+1e-6), on qpos and
    qvel. `model` and `label` name another env's compiled model and path
    (the randomized reach env's)."""
    from robogym_torch import bridge
    from robogym_torch.envs import core
    from robogym_torch.physics import step

    fields = {k: v[:n] for k, v in state.model_fields.items()}
    m = core.apply_model_fields(model if model is not None else wenv.env.model, fields)
    d = core.data_map(lambda x: x[:n], state.physics)
    got = step.step(m, d)
    with plain_versions():
        want = step.step(m, d)
        m64 = bridge.model_to(m, m.device, torch.float64)
        exact = step.step(m64, core.data_map(
            lambda x: x.double() if x.is_floating_point() else x, d))
    torch.cuda.synchronize()
    for k in ("qpos", "qvel"):
        g, w, x = (getattr(o, k) for o in (got, want, exact))
        e_k, e_p = rel_err(g.double(), x), rel_err(w.double(), x)
        print(f"[whole step] {label}, B={n} one substep with per-env model fields: {k} rel "
              f"err vs float64: kernels {e_k:.3g}, plain versions {e_p:.3g} (at most "
              f"{NOISE_RATIO} x + 1e-6)")
        check(bool(torch.isfinite(g).all()) and e_k <= NOISE_RATIO * e_p + 1e-6,
              f"{label} whole step: {k} err vs float64 {e_k:.3g} > {NOISE_RATIO} x the plain "
              f"version's {e_p:.3g}")


# the Rubik's envs: their module, the stack they are wrapped in, their
# stand-in world and its snapshot
RUBIK = {"face": dict(module="face_perpendicular", wrap="apply_face_wrappers",
                      world="the cubelet world", steps=ENV_STEPS),
         "full": dict(module="full_perpendicular", wrap="apply_full_wrappers",
                      world="the 20-cubelet world", steps=FULL_STEPS)}


def legal_share(env, qpos) -> float:
    """The share of envs whose cube is legal (`goals_solver.legal_cubes`:
    its faces soft-aligned and its cubelet matrices rounded give nine
    facelets of each colour, each centre its own)."""
    from robogym_torch.envs.dactyl import goals_solver

    return float(goals_solver.legal_cubes(env.cubelets, qpos).mean())


def rubik_env_reset(batch, kind="face", bare=None):
    """A Rubik's env on the card (`envs/dactyl/<module>.make_env`, `kind`
    "face" or "full" of RUBIK, whose construction runs the zero-control
    settle on its stand-in world), or, given the `bare` env, a copy of it
    with a generator of its own (its construction shared) in its stack
    (`wrappers.apply_face_wrappers` or `apply_full_wrappers`, randomize=True:
    the default dactyl stack, the face drivers' damping, and for the full
    env the cube's size), and its reset at `batch` envs from seed 0: (env,
    state, readings). Prints the construction and reset times, the
    retries, the share of envs with the cube on the palm and the reset
    goals' types, and for the full env the share of legal cubes
    (`legal_share`) and of envs above the contact budget; checks the state
    and the obs finite."""
    from robogym_torch import wrappers
    from robogym_torch.envs.dactyl import cube_env

    spec = RUBIK[kind]
    wrapped = bare is not None
    label = f"wrapped_{kind}_env" if wrapped else f"{kind}_env"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if wrapped:
        env = copy.copy(bare)
        env.generator = torch.Generator(device=bare.device)
        env.generator.manual_seed(SEED)
    else:
        module = importlib.import_module("robogym_torch.envs.dactyl." + spec["module"])
        with MEMO.construction(label.replace("_", " ")):
            env = module.make_env(device="cuda", seed=SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wenv = getattr(wrappers, spec["wrap"])(env, randomize=True) if wrapped else env
    state, obs = wenv.reset(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    on_palm = float(cube_env.is_on_palm(env.cube, state.physics).float().mean())
    flip = float((state.goal["goal_type"] == 0).float().mean())
    built = (f"the {kind} env's construction, copied" if wrapped else
             f"built (its settle, {env.constants.reset_initial_steps * env.constants.mujoco_substeps}"
             f" substeps at B=1) in {t1 - t0:.2f} s")
    readings = dict(build_s=t1 - t0, reset_s=t2 - t1, retries=env.reset_retries,
                    on_palm_reset=on_palm, goal_flip_reset=flip)
    extra = ""
    if kind == "full":
        live = state.physics.contact.active.sum(1)
        readings.update(legal_reset=legal_share(env, state.physics.qpos),
                        over_budget_reset=float((live > env.model.opt.ncon_active).float().mean()))
        extra = (f"; legal cubes {readings['legal_reset']:.4f}; above "
                 f"{env.model.opt.ncon_active} live contacts {readings['over_budget_reset']:.4f}")
    print(f"[state] {label} on {spec['world']} (nv={env.model.const.nv}"
          f"{f', {len(wenv.transforms)} transforms' if wrapped else ''}): {built}; "
          f"reset at B={batch} in {t2 - t1:.2f} s, {env.reset_retries} "
          f"retries, on the palm {on_palm:.4f}; reset goals flip {flip:.4f}, rotation "
          f"{1 - flip:.4f}{extra}")
    for k in ("qpos", "qvel", "qacc"):
        check(bool(torch.isfinite(getattr(state.physics, k)).all()),
              f"{label} reset: non-finite {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"{label} reset: non-finite obs {k}")
    return wenv, state, readings


def rubik_env_steps(wenv, state, out, actions, label, steps=ENV_STEPS):
    """`steps` env steps of a Rubik's env (bare or wrapped) from `state`
    with `actions()`; checks every obs and reward finite, and puts into
    `out` the reward sum, the episodes done, the share on the palm, the
    goals drawn by type over the run (the reset's and each resample's), the
    largest |face angle|, the last state and, for the wrapped env, each
    step's timestep field. Returns the last physics state."""
    from robogym_torch.envs.dactyl import cube_env

    env = getattr(wenv, "env", wenv)
    rewards, done, finite, timesteps = 0.0, 0, {}, []
    drawn = torch.stack([(state.goal["goal_type"] == t).sum() for t in (0, 1)])
    face_max = env.face_angles(state.physics).abs().max()
    for _ in range(steps):
        prev = state.tracker.goals_so_far
        state, obs, reward, dn, _ = wenv.step(state, actions())
        for k, v in dict(obs, reward=reward).items():   # read after the run: no sync here
            ok = torch.isfinite(v).all()
            finite[k] = finite[k] & ok if k in finite else ok
        new = state.tracker.goals_so_far > prev
        drawn = drawn + torch.stack([(new & (state.goal["goal_type"] == t)).sum() for t in (0, 1)])
        face_max = torch.maximum(face_max, env.face_angles(state.physics).abs().max())
        rewards = rewards + reward.sum(0)
        done = done + dn.sum()
        if state.model_fields is not None:
            timesteps.append(state.model_fields["opt:timestep"])
    for k, ok in finite.items():
        check(bool(ok), f"{label} path: non-finite {k}")
    drawn = [int(x) for x in drawn]
    out.update(reward_sum=[float(x) for x in rewards], done=int(done),
               on_palm=float(cube_env.is_on_palm(env.cube, state.physics).float().mean()),
               goals_drawn={"flip": drawn[0], "rotation": drawn[1]},
               face_angle_max=float(face_max), timesteps=timesteps, state=state)
    return state.physics


def budget_reading(label, model, d):
    """Live contacts per env at the last substep of a path against the
    contact budget `ncon_active` (the rows beyond it are dropped, as the
    JAX package drops them)."""
    live = d.contact.active.sum(1)
    cap = model.opt.ncon_active
    over = float((live > cap).float().mean())
    print(f"[path {label}] the last substep, B={live.shape[0]}: live contacts per env mean "
          f"{float(live.float().mean()):.2f}, max {int(live.max())}; above ncon_active={cap} "
          f"(rows dropped) in {over:.4f} of envs")
    return dict(live_mean=float(live.float().mean()), live_max=int(live.max()),
                dropped_share=over)


def rubik_path_readings(label, wenv, readings, out, wall, batch, steps=ENV_STEPS):
    """Print a Rubik's path's readings (after `rubik_env_steps`); returns
    the path's record fields."""
    env = getattr(wenv, "env", wenv)
    sps = batch * steps / wall
    drawn = out["goals_drawn"]
    n = drawn["flip"] + drawn["rotation"]
    budget = budget_reading(label, env.model, out["state"].physics)
    print(f"[path {label}] {steps} env steps x {SUBSTEPS} substeps at B={batch}: "
          f"{wall:.3f} s, {sps:.1f} env-steps/s; qpos, qvel, obs and rewards finite; on the "
          f"palm {readings['on_palm_reset']:.4f} after the reset, {out['on_palm']:.4f} after the "
          f"steps; goals drawn {n}: flip {drawn['flip'] / n:.4f}, rotation "
          f"{drawn['rotation'] / n:.4f}; largest |face angle| {out['face_angle_max']:.4f} rad; "
          f"reward sum {out['reward_sum']} (env, goal distance, success), episodes done "
          f"{out['done']}")
    return dict(env_steps=steps, substeps=SUBSTEPS, env_steps_per_s=sps,
                reward_sum=out["reward_sum"], done=out["done"], on_palm=out["on_palm"],
                goals_drawn=drawn, face_angle_max=out["face_angle_max"], budget=budget,
                **readings)


def damping_spread(wenv, fields, label):
    """The spread of `dof_damping` across envs on each cube dof: nonzero on
    exactly the face drivers (`cube:cubelet:driver:*`, the face-damping
    transform's dofs), zero on the cube's other dofs."""
    damp = fields["dof_damping"]
    env = wenv.env
    c = env.model.const
    drivers = sorted(int(c.jnt_dofadr[i]) for n, i in c.names["joint"].items()
                     if n.startswith("cube:cubelet:driver:"))
    cube_dofs = range(int(env.cube.cube_pos_dof[0]), c.nv)
    spread = {i: float(damp[:, i].max() - damp[:, i].min()) for i in cube_dofs}
    varied = sorted(i for i, v in spread.items() if v > 0)
    print(f"[path {label}] dof_damping across envs on the driver dofs {drivers}: "
          + ", ".join(f"dof {i} {float(damp[:, i].min()):.4g} to {float(damp[:, i].max()):.4g}"
                      for i in drivers)
          + f"; cube dofs that differ across envs: {varied}")
    check(varied == drivers, f"{label}: dof_damping varies on cube dofs {varied}, want exactly "
          f"the drivers {drivers}")
    return {str(i): spread[i] for i in drivers}


def size_spread(wenv, fields, label):
    """The geoms whose `geom_size` differs across envs: exactly the cube's
    pieces (`cube:cubelet*`, the perpendicular cube-size transform's)."""
    size = fields["geom_size"]
    c = wenv.env.model.const
    pieces = sorted(i for n, i in c.names["geom"].items() if n.startswith("cube:cubelet"))
    varied = torch.nonzero((size.amax(0) > size.amin(0)).any(-1)).flatten().tolist()
    scale = size[:, pieces] / wenv.env.model.geom_size[pieces]
    print(f"[path {label}] geom_size differs across envs on {len(varied)} geoms (the cube's "
          f"{len(pieces)} pieces: {varied == pieces}); scale {float(scale.min()):.4f} to "
          f"{float(scale.max()):.4f}")
    check(varied == pieces, f"{label}: geom_size varies on geoms {varied}, want the pieces "
          f"{pieces}")
    return dict(geoms=len(varied), scale_min=float(scale.min()), scale_max=float(scale.max()))


def capture_rubik_step(env, state):
    """The kernels' inputs in the last substep of one Rubik's env step from
    `state`: (core inputs, CG iterations, facets per contact) and the
    "hull_manifold" and "boxbox" arguments."""
    from robogym_torch.physics import constraint_batched
    from robogym_torch.physics.collision import boxbox_kernel, convex_kernel

    act = rearrange_actions(env, state.t.shape[0])()
    calls = capture_ends([(constraint_batched, "fused_step_core"),
                          (convex_kernel, "hull_manifold"), (boxbox_kernel, "boxbox")],
                         lambda: env.step(state, act))
    kind_s, iterations, nfacet, *args = calls["fused_step_core"][1]
    return dict(core=(constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet),
                hull_manifold=calls["hull_manifold"][1], boxbox=calls["boxbox"][1])


def b_rows_line(label, E, V):
    """Kernel B's rows at E rows and V dofs: row groups of 32, those a lane
    keeps in registers, those spilled to shared memory (cg_full.cu
    `reg_rows`, `layout`)."""
    nk = (E + 31) // 32
    R = min(max(nk, 1), 8) if V <= 32 else 8 if V <= 64 else 4
    spill = max(nk - R, 0)
    print(f"[{label}] kernel B's rows: {nk} groups of 32, {min(nk, R)} in registers, {spill} "
          f"spilled to shared memory ({max(E - 32 * R, 0)} rows)")
    return dict(row_groups=nk, register_groups=min(nk, R), spilled_groups=spill)


def solver_hop(env, n=SOLVER_HOP_ENVS):
    """The solver goals' host hop on a copy of the full env under
    face_cube_solver: a reset of n envs (each plan empty), then
    `goals_solver.solve_and_attach` (one two-phase solve an env, on the
    host); checks every plan non-empty and `solver_plan_empty` false in
    every env after one step. Returns the readings."""
    from robogym_torch.envs.dactyl import goals_solver

    env = copy.copy(env)
    env.constants = dataclasses.replace(env.constants, goal_generation="face_cube_solver")
    env.generator = torch.Generator(device=env.device)
    env.generator.manual_seed(SEED)
    state, _ = env.reset(n)
    check(not bool(state.goal_aux[1].any()), "solver hop: a plan before the hop")
    legal = legal_share(env, state.physics.qpos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = goals_solver.solve_and_attach(env, state)
    torch.cuda.synchronize()
    per_solve = (time.perf_counter() - t0) / n
    lengths = [int(x) for x in state.goal_aux[1]]
    _, _, _, _, info = env.step(state, rearrange_actions(env, n)())
    empty = int(info["solver_plan_empty"].sum())
    print(f"[solver hop] face_cube_solver reset at B={n}: legal cubes {legal:.4f}; "
          f"solve_and_attach {1e3 * per_solve:.2f} ms of host a solve; plan lengths {lengths}; "
          f"after one step solver_plan_empty in {empty} envs, plan steps "
          f"{[int(x) for x in info['solver_plan_step']]}")
    check(min(lengths) > 0, f"solver hop: empty plans, lengths {lengths}")
    check(empty == 0, f"solver hop: solver_plan_empty in {empty} envs after a step")
    return dict(envs=n, legal=legal, host_ms_per_solve=1e3 * per_solve, plan_lengths=lengths)


def nudge_rule(label, got, want, nudged, cube_cols):
    """The kernels' state `got` against the plain versions' `want` (Data of
    n envs) by the CPU tests' nudge rule over the whole batch (as
    tests/_torch_common.py's `assert_physics_close(..., whole=True)` holds
    a reset's or a rearrange step's many contact-rich substeps): per group
    of the env-step ENVELOPE, the largest difference over the envs at most
    NUDGE_RATIO times the largest drift of the kernels' own `nudged` runs
    from `got`, or within the envelope. Also prints the envs that a nudged
    run takes out of the envelope (chaotic) and the largest difference on
    the others."""
    def err(a, b, field, cols):
        return (getattr(a, field)[:, cols] - getattr(b, field)[:, cols]).abs().amax(-1)

    groups = [(name, field, cube_cols if name == "cube position" else slice(None), tol)
              for name, field, tol in ENVELOPE]
    chaotic = torch.zeros(got.qpos.shape[0], dtype=torch.bool, device=got.qpos.device)
    for _, field, cols, tol in groups:
        for dn in nudged:
            chaotic |= err(dn, got, field, cols) > tol
    n_chaotic = int(chaotic.sum())
    for name, field, cols, tol in groups:
        e = err(got, want, field, cols)
        drift = max(float(err(dn, got, field, cols).max()) for dn in nudged)
        worst = float(e.max())
        calm = float(e[~chaotic].max()) if n_chaotic < e.shape[0] else 0.0
        line = (f"max {worst:.3g}, the nudged runs' largest drift {drift:.3g} (at most "
                f"{NUDGE_RATIO} x, or {tol:g}); {n_chaotic} of {e.shape[0]} envs chaotic, the "
                f"others' max {calm:.3g}")
        print(f"[whole step] {label}: {name} {line}")
        check(bool(torch.isfinite(got.qpos).all()) and worst <= max(NUDGE_RATIO * drift, tol),
              f"whole step {label}: {name} outside the nudge rule: {line}")


def nudged_agreement(label, model, state, cols, substeps=SUBSTEPS, n=64):
    """`substeps` substeps of `model` (each env's own model fields where
    `state` has them) on the first n envs of a path's last `state` (an env
    state, or the physics Data of a model without fields), through the
    kernels and through the plain versions, held by `nudge_rule` on the
    qpos columns `cols` with NUDGED_RUNS runs of the kernels from start
    qvels nudged by NUDGE, stepped as one batch. For the worlds whose
    substeps part on discontinuities: the Rubik's envs' contacts, where the
    rule's per-env form fails on envs that no nudged run takes out of the
    envelope (on an H100, one env's qvel 0.122 apart against the envelope's
    0.05, PERF.md: over 10 substeps the two CG summation orders part
    further than a 1e-6 nudge moves one env); the mesh-family worlds' CG
    line-search near-ties (ROADMAP section 3, item 2), where one env's pick
    moves its qvel past the strict whole-step tolerance (the table
    setting's by 0.13 against 0.00653 in one substep, PERF.md); and the
    Newton solve's line search, an argmin over six float32 costs."""
    from robogym_torch.envs import core
    from robogym_torch.physics import step

    physics = getattr(state, "physics", state)
    n = min(n, physics.qpos.shape[0])
    d = core.data_map(lambda x: x[:n], physics)
    fields = {k: v[:n] for k, v in (getattr(state, "model_fields", None) or {}).items()}
    m = core.apply_model_fields(model, fields)
    got = step.step_n(m, d, substeps)
    with plain_versions():
        want = step.step_n(m, d, substeps)
    k = NUDGED_RUNS
    tiled = core.data_map(lambda x: x.repeat((k,) + (1,) * (x.dim() - 1)), d)
    gen = torch.Generator(device=d.qvel.device)
    gen.manual_seed(SEED)
    qvel = tiled.qvel + NUDGE * torch.randn(tiled.qvel.shape, generator=gen,
                                            device=d.qvel.device, dtype=d.qvel.dtype)
    m_k = core.apply_model_fields(model, {f: v.repeat((k,) + (1,) * (v.dim() - 1))
                                          for f, v in fields.items()})
    runs = step.step_n(m_k, tiled.replace(qvel=qvel), substeps)
    nudged = [core.data_map(lambda x: x[i * n:(i + 1) * n], runs) for i in range(k)]
    torch.cuda.synchronize()
    nudge_rule(f"{label}, B={n} {substeps} substep(s), kernels vs plain versions", got, want,
               nudged, torch.as_tensor(np.asarray(cols), device=d.qpos.device))


def object_cols(env):
    """The qpos columns of a rearrange env's objects' positions."""
    return np.concatenate([np.arange(a, a + 3) for a in env.idx.object_qpos_adr])


def reach_env_reset(batch):
    """The reach env on the card (`reach.make_env`, whose construction
    settles one env for 200 substeps) and its reset at `batch` envs (each
    env's first goal from a goal sim of 20 substeps): (env, state,
    construction s, reset s). Checks the state and the observations
    finite."""
    from robogym_torch.envs.dactyl import reach

    t0 = time.perf_counter()
    with MEMO.construction("reach env"):
        env = reach.make_env(device="cuda", seed=SEED)
    t1 = time.perf_counter()
    state, obs = env.reset(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c = env.model.const
    print(f"[state] reach env on the reach stand-in world (nv={c.nv}, "
          f"{len(c.collision_pairs)} collision pairs): built (its settle, "
          f"{20 * env.constants.mujoco_substeps} substeps at B=1) in {t1 - t0:.2f} s; "
          f"ReachEnv.reset at B={batch} in {t2 - t1:.2f} s (goal sim "
          f"{env.constants.goal_stabilize_steps * env.constants.mujoco_substeps} substeps); "
          f"first goals' distance mean {float(state.prev_goal_distance['fingertip_pos'].mean()):.4f} m")
    for k in ("qpos", "qvel", "qacc"):
        check(bool(torch.isfinite(getattr(state.physics, k)).all()), f"reach env reset: non-finite {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"reach env reset: non-finite obs {k}")
    return env, state, t1 - t0, t2 - t1


def reach_env_steps(env, state, out, steps=REACH_STEPS):
    """`steps` ReachEnv.step calls from `state` (each env's `model_fields`
    applied), actions uniform in [-1, 1] from a seeded generator; one env
    in 8 holds a pending success before the first step, so that the goal
    sim runs on the gathered resampling envs at load. After that step the
    envs whose goal did not resample must keep their goals unchanged, and
    the resampled goals must be finite. Checks every obs and reward finite
    and puts the reward sum, the episodes done, the success share over the
    steps, the goal sims, the envs they resampled and the last state into
    `out`. Returns the last physics state."""
    B = state.t.shape[0]
    pending = torch.zeros(B, dtype=torch.bool, device=env.device)
    pending[::8] = True
    state = state.replace(tracker=state.tracker.replace(success_and_no_goal_reset=pending))
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    sims, envs = env.goal_sims, env.goal_sim_envs
    rewards, done, success, finite = 0.0, 0, 0.0, {}
    for i in range(steps):
        action = torch.rand((B, env.action_size), generator=gen, device=env.device) * 2.0 - 1.0
        before, goals = dict(state.goal, goal_aux=state.goal_aux), state.tracker.goals_so_far
        state, obs, reward, dn, info = env.step(state, action)
        if i == 0:
            new = state.tracker.goals_so_far != goals
            n = int(new.sum())
            check(bool(new[pending].all()) and env.goal_sim_envs - envs == n,
                  f"reach path: {n} goals resampled, {env.goal_sim_envs - envs} goal-sim envs, "
                  f"{int(pending.sum())} pending")
            for k, v in dict(state.goal, goal_aux=state.goal_aux).items():
                check(bool((v[~new] == before[k][~new]).all()), f"reach path: kept goal {k} moved")
                check(bool(torch.isfinite(v[new]).all()), f"reach path: resampled goal {k} not finite")
        for k, v in dict(obs, reward=reward).items():   # read after the run: no sync here
            ok = torch.isfinite(v).all()
            finite[k] = finite[k] & ok if k in finite else ok
        rewards = rewards + reward.sum(0)
        done = done + dn.sum()
        success = success + info["is_successful"].float().mean()
    for k, ok in finite.items():
        check(bool(ok), f"reach path: non-finite {k}")
    out.update(reward_sum=[float(x) for x in rewards], done=int(done),
               success_share=float(success) / steps, goal_sims=env.goal_sims - sims,
               goal_resamples=env.goal_sim_envs - envs, state=state)
    return state.physics


def reach_calls(env, out, steps=REACH_STEPS):
    """The substeps of a reach path: each step's and each goal sim's."""
    return lambda: (steps + out["goal_sims"] * env.constants.goal_stabilize_steps) * SUBSTEPS


def reach_path_line(label, env, out, wall, batch, steps=REACH_STEPS):
    sps = batch * steps / wall
    print(f"[path {label}] {steps} ReachEnv.step calls x {SUBSTEPS} substeps at B={batch}: "
          f"{wall:.3f} s, {sps:.1f} env-steps/s; reward sum {out['reward_sum']} (env, goal "
          f"distance, success), episodes done {out['done']}, success share "
          f"{out['success_share']:.4f}, goal sims {out['goal_sims']} resampling "
          f"{out['goal_resamples']} envs")
    return dict(env_steps=steps, substeps=SUBSTEPS, env_steps_per_s=sps,
                reward_sum=out["reward_sum"], done=out["done"], success_share=out["success_share"],
                goal_sims=out["goal_sims"], goal_resamples=out["goal_resamples"])


def ppo_train_steps(env, state, out, steps=PPO_STEPS):
    """The training path on the reach env from `state`: a policy of
    PPO_HIDDEN hidden units (`train.ppo.init_policy`, seeded) through a
    one-rank `parallel.mesh`, `steps` `train_step`s (observe, clipped
    Gaussian actions, one env step, one-step GAE, one PPO update), then a
    PPO_ROLLOUT_STEPS-step `parallel.rollout.make_rollout_fn` with the
    policy sampling the actions. Puts each train step's seconds, loss and
    mean reward, the first and the last policy, the goal sims and the
    rollout's metrics into `out`. Returns the last physics state."""
    from robogym_torch.parallel import mesh as mesh_lib
    from robogym_torch.parallel import rollout
    from robogym_torch.train import ppo

    mesh = mesh_lib.make_mesh(device=env.device)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    obs_size = ppo.flatten_obs(env._observe(state)).shape[-1]
    policy = out["policy0"] = ppo.init_policy(gen, obs_size, env.action_size, PPO_HIDDEN, mesh)
    sims = env.goal_sims
    seconds, losses, rewards = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        policy, state, reward, loss = ppo.train_step(env, policy, state, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        rewards.append(float(reward))

    def sample(obs, noise):
        mean, log_std, _ = ppo.policy_apply(policy, ppo.flatten_obs(obs))
        return torch.clamp(mean + noise * torch.exp(log_std), -1.0, 1.0)

    with torch.no_grad():
        state, metrics = rollout.make_rollout_fn(env, mesh, PPO_ROLLOUT_STEPS, sample)(state, gen)
    out.update(policy=policy, state=state, seconds=seconds, losses=losses, rewards=rewards,
               goal_sims=env.goal_sims - sims,
               rollout={k: float(v) for k, v in metrics.items()})
    return state.physics


def ppo_readings(env, out, wall, batch, steps=PPO_STEPS):
    """The training path's checks after its run: the losses and the mean
    rewards finite, the parameters moved; on one more batch from the last
    state (`train.ppo.act`) the gradients finite, PPO's ratio at the old
    parameters 1 within RATIO_TOL, and the update's device time. Prints
    and returns the readings."""
    from robogym_torch.train import ppo

    p0, p1 = out["policy0"], out["policy"]
    moved = [k for k in ppo.FIELDS if not torch.equal(getattr(p0, k), getattr(p1, k))]
    check(all(np.isfinite(out["losses"])) and all(np.isfinite(out["rewards"])),
          f"ppo_train: losses {out['losses']}, mean rewards {out['rewards']}")
    check(set(moved) == set(ppo.FIELDS), f"ppo_train: only {moved} moved")
    noise = torch.randn((batch, env.action_size), generator=torch.Generator(
        device=env.device).manual_seed(SEED + 1), device=env.device)
    _, pb, _ = ppo.act(env, p1, out["state"], noise)
    loss, grads = ppo.ppo_grads(p1, pb)
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "ppo_train: non-finite loss or gradients")
    with torch.no_grad():
        mean, log_std, _ = ppo.policy_apply(p1, pb.obs)
        ratio_err = float((torch.exp(ppo.gaussian_logp(mean, log_std, pb.actions) - pb.logp_old)
                           - 1).abs().max())
    check(ratio_err <= RATIO_TOL, f"ppo_train: ratio at the old parameters off 1 by {ratio_err:.3g}")
    update_ms = timed_ms(lambda: ppo.ppo_update(p1, pb), REPS)
    train_s = sum(out["seconds"])
    r = dict(env_steps=steps, train_env_steps_per_s=batch * steps / train_s,
             step_seconds=out["seconds"], losses=out["losses"], reward_means=out["rewards"],
             update_ms=update_ms, ratio_err=ratio_err, grad_max={k: float(g.abs().max())
                                                                 for k, g in grads.items()},
             goal_sims=out["goal_sims"], rollout=out["rollout"])
    print(f"[path ppo_train] {steps} train steps of the reach env at B={batch} (hidden "
          f"{PPO_HIDDEN}, one rank of parallel.mesh) and a {PPO_ROLLOUT_STEPS}-step rollout with "
          f"the policy: {wall:.3f} s; train steps {train_s:.3f} s, "
          f"{r['train_env_steps_per_s']:.1f} env-steps/s (each " + ", ".join(
              f"{x:.3f}" for x in out["seconds"]) + " s); loss per step " + ", ".join(
              f"{x:.6g}" for x in out["losses"]) + "; mean reward per step " + ", ".join(
              f"{x:.6g}" for x in out["rewards"]) + f"; the update {update_ms:.4f} ms (CUDA "
          f"events); ratio at the old parameters within {ratio_err:.3g} of 1; gradients finite; "
          f"every parameter moved; rollout metrics {out['rollout']}; goal sims {out['goal_sims']}")
    return r


def reach_helper_reset(renv, rstate, batch):
    """The rearrange blocks env in joint control mode (`REACH_HELPER_CONFIG`)
    on the card, built on the rearrange env `renv`'s main world, and its
    start: the first `batch` envs of `renv`'s reset state `rstate` (the
    same world, configuration and reset; joint control keeps no solver
    sim, so its goal carry is zeros, as its own reset's): (env, state,
    construction s)."""
    from robogym_torch.envs import core
    from robogym_torch.envs.rearrange import blocks

    t0 = time.perf_counter()
    with MEMO.construction("reach helper env"):
        env = blocks.make_env(*REACH_HELPER_CONFIG, seed=SEED, worlds={"model": renv.model})
    built = time.perf_counter() - t0
    check(REACH_HELPER_CONFIG[1]["simulation_params"] == REARRANGE_CONFIG[1]["simulation_params"]
          and env.solver_model is None, "reach_helper: not the rearrange env's configuration")
    state = core.take_envs(rstate, torch.arange(batch, device=env.device))
    state = state.replace(goal_aux=torch.zeros(batch, dtype=env.dtype, device=env.device))
    for k in ("qpos", "qvel"):
        check(bool(torch.isfinite(getattr(state.physics, k)).all()),
              f"reach_helper start: non-finite {k}")
    print(f"[state] rearrange env in joint control mode (action size {env.action_size}, no "
          f"solver sim): built in {built:.2f} s; its start the rearrange env's reset state's "
          f"first {batch} envs")
    return env, state, built


def reach_helper_run(env, state, out):
    """`robot.reach_helper.reach_position` from `state` to each env's arm
    pose plus REACH_HELPER_OFFSET on every arm joint, at most
    REACH_HELPER_STEPS env steps. Puts the result and the state into
    `out`. Returns the physics state."""
    from robogym_torch.robot import reach_helper, ur16e

    cur = ur16e.joint_positions(env.robot.arm, state.physics).double()
    out["target"] = (cur + REACH_HELPER_OFFSET).cpu().numpy()
    final, res = reach_helper.reach_position(env, state, out["target"],
                                             timeout_steps=REACH_HELPER_STEPS)
    out.update(result=res, state=final)
    return final.physics


def reach_helper_readings(env, out, wall, batch, built):
    """The reach_helper path's checks: every env reached and stopped
    within REACH_HELPER_STEPS steps, its arm in its returned state within
    the threshold. Prints and returns the readings."""
    from robogym_torch.robot import reach_helper, ur16e

    res = out["result"]
    steps = int(res.steps.max())
    thr = reach_helper._DEFAULTS[reach_helper.MeasurementUnit.RADIANS]
    arm = ur16e.joint_positions(env.robot.arm, out["state"].physics).double().cpu().numpy()
    err = float(np.abs(arm - out["target"]).max())
    check(bool(res.reached.all()) and steps <= REACH_HELPER_STEPS,
          f"reach_helper: reached {res.reached.tolist()} in steps {res.steps.tolist()}")
    check(err < thr["reached_position_threshold"], f"reach_helper: final arm error {err:.3g}")
    r = dict(batch=batch, env_steps=steps, env_steps_per_s=batch * steps / wall, build_s=built,
             steps_by_env=res.steps.tolist(), final_error=err)
    print(f"[path reach_helper] reach_position of the rearrange env in joint mode at B={batch}, "
          f"a target {REACH_HELPER_OFFSET} rad from the reset pose on each arm joint: every env "
          f"reached and stopped in {sorted(set(res.steps.tolist()))} steps ({steps} env steps "
          f"of {env.constants.mujoco_substeps} substeps in {wall:.3f} s, "
          f"{r['env_steps_per_s']:.1f} env-steps/s; built in {built:.2f} s); largest final arm "
          f"error {err:.3g} rad")
    return r


def capture_reach_substep(env, state):
    """The kernels' inputs in the last of SUBSTEPS substeps of the reach
    env's physics from `state` under a relative zero action (an env step's
    main sim, no goal sim): (core inputs, CG iterations, facets per
    contact) and the "hull_manifold" and "hull_pair" arguments."""
    from robogym_torch.physics import constraint_batched, step
    from robogym_torch.physics.collision import convex_kernel
    from robogym_torch.robot import shadow_hand

    d = state.physics
    ctrl = shadow_hand.denormalize_position_control(
        env.hand, env.model, d, torch.zeros((d.qpos.shape[0], 20), device=env.device),
        relative_action=True)
    calls = capture_ends([(constraint_batched, "fused_step_core"),
                          (convex_kernel, "hull_manifold"), (convex_kernel, "hull_pair")],
                         lambda: step.step_n(env.model, d.replace(ctrl=ctrl), SUBSTEPS))
    kind_s, iterations, nfacet, *args = calls["fused_step_core"][1]
    return dict(core=(constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet),
                hull_manifold=calls["hull_manifold"][1], hull_pair=calls["hull_pair"][1])


def effort_check(env, state):
    """One substep of the reach model under effort control
    (`shadow_hand.effort_control_model`) from `state` at its batch, a
    seeded command in [-1, 1]: `actuator_effort` must give the command
    back to EFFORT_TOL (tests/test_parity_extras.py's check), clipped where
    it clips: the actuation clamps the control to its range [-1, 1] before
    the force limit, so on an actuator whose limit is above 1 (the
    wrist's, THJ4's, THJ3's) a command above 1 / limit comes back as
    1 / limit."""
    from robogym_torch.physics import step
    from robogym_torch.robot import shadow_hand

    m = shadow_hand.effort_control_model(env.hand, env.model)
    d = state.physics
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    cmd = torch.rand((d.qpos.shape[0], 20), generator=gen, device=env.device) * 2.0 - 1.0
    d = step.step(m, d.replace(ctrl=shadow_hand.set_effort_control(env.hand, m, d, cmd)))
    ids = torch.as_tensor(env.hand.actuator_ids, device=env.device)
    limits, cr = m.actuator_forcerange[ids], m.actuator_ctrlrange[ids]
    raw = shadow_hand.denormalize_by_limit(cmd, limits)
    force = torch.clamp(raw, cr[:, 0], cr[:, 1])
    want = shadow_hand.normalize_by_limits(torch.clamp(force, limits[:, 0], limits[:, 1]), limits)
    clipped = float((force != raw).float().mean())
    err = float((shadow_hand.actuator_effort(env.hand, m, d) - want).abs().max())
    print(f"[effort] one effort-control substep of the reach model at B={cmd.shape[0]}: "
          f"actuator_effort vs the command (clipped to the control range on "
          f"{100 * clipped:.2f} % of the entries) max abs err {err:.3g} (tol {EFFORT_TOL}); "
          f"qvel finite {bool(torch.isfinite(d.qvel).all())}")
    check(err <= EFFORT_TOL and bool(torch.isfinite(d.qvel).all()),
          f"effort control: actuator_effort {err:.3g} from its command")
    return dict(batch=cmd.shape[0], max_abs_err=err, clipped_share=clipped)


def reach_randomization(env):
    """The randomized reach env's EnvRandomization: a simulation chain of
    gravity, joint margins, geom solref, and GenericSimRandomizer on
    dof_damping (joints `robot0:`) and geom_friction (geoms `robot0:`),
    bound to the env's model, its ADR values set by path (REACH_ADR)."""
    from robogym_torch.randomization import env as renv
    from robogym_torch.randomization import sim

    sims = [sim.GravityRandomizer(), sim.JointMarginRandomizer(), sim.GeomSolrefRandomizer(),
            sim.GenericSimRandomizer("dof_damping", "dof_damping", dof_jnt_prefix="robot0:"),
            sim.GenericSimRandomizer("geom_friction", "geom_friction", geom_prefix="robot0:")]
    for r in sims:
        r.initialize(env.model)
    rand = renv.build_env_randomization(simulation_randomizers=sims)
    for path, value in REACH_ADR:
        rand.update_parameter(path, value)
    return rand


def randomized_reach_reset(bare, batch):
    """A copy of the reach env `bare` with a generator of its own, seeded as
    `make_env` seeds one, its simulation chain's draws for `batch` envs
    applied as per-env model fields on its reset state: (env, chain,
    state)."""
    env = copy.copy(bare)
    env.generator = torch.Generator(device=bare.device)
    env.generator.manual_seed(SEED)
    chain = reach_randomization(env).get_randomizer("sim")
    t0 = time.perf_counter()
    fields = chain.apply({}, chain.draw(env.generator, batch), chain.param_values())
    state, _ = env.reset(batch)
    state = state.replace(model_fields=fields)
    torch.cuda.synchronize()
    print(f"[state] randomized reach env: {len(chain.get_randomizers())} sim randomizers, "
          f"ADR values {dict(REACH_ADR)}; drawn, applied and reset at B={batch} in "
          f"{time.perf_counter() - t0:.2f} s; per-env fields {sorted(fields)}")
    return env, chain, state


def sim_field_spread(env, chain, fields, label="randomized_reach_env"):
    """Each randomized field must vary across envs on exactly the ids its
    randomizer selects (gravity's three components, every joint's margin,
    every geom's solref, the `robot0:` dofs' damping and geoms' friction)
    and equal the compiled model's on the others. Returns {field:
    spread}."""
    from robogym_torch.randomization.sim import GenericSimRandomizer
    from robogym_torch.wrappers.core import model_field

    c = env.model.const
    want = {"opt:gravity": range(3), "jnt_margin": range(c.njnt), "geom_solref": range(c.ngeom)}
    for r in chain.get_randomizers():
        if isinstance(r, GenericSimRandomizer):
            want[r.field_name] = r.ids
    spread = {}
    for k, v in fields.items():
        per_row = (v.amax(0) - v.amin(0)).reshape(v.shape[1], -1).amax(-1)
        varied = sorted(int(i) for i in torch.nonzero(per_row > 0).flatten())
        spread[k] = float(per_row.max())
        print(f"[path {label}] {k} varies across envs on {len(varied)} of {v.shape[1]} rows, "
              f"spread {spread[k]:.4g}")
        check(varied == sorted(int(i) for i in want[k]),
              f"{label}: {k} varies on rows {varied}, want {sorted(int(i) for i in want[k])}")
        base = model_field(env.model, k).expand_as(v)
        rest = per_row <= 0
        check(bool((v == base)[:, rest].all()), f"{label}: {k} moved on unselected rows")
    check(sorted(fields) == sorted(want), f"{label}: fields {sorted(fields)}")
    return spread


def vision_env_reset(batch):
    """The locked env with dummy vision (`locked.make_env` with
    `vision_observation_provider="dummy_vision"`) and its reset at
    `batch` envs: (env, state). Checks the images: (B, 3, 200, 200, 3)
    uint8 zeros, the goal images cached in `goal_aux`."""
    from robogym_torch.envs.dactyl import locked

    t0 = time.perf_counter()
    with MEMO.construction("dummy vision env"):
        env = locked.make_env({"vision_observation_provider": "dummy_vision"}, device="cuda",
                              seed=SEED)
    state, obs = env.reset(batch)
    torch.cuda.synchronize()
    check_images("locked dummy-vision reset", obs, batch)
    cache = state.goal_aux[1]
    check(cache["goal_dummy_vision"]["vision_goal"] is obs["vision_goal"],
          "locked dummy-vision reset: vision_goal is not the cached tensor")
    print(f"[state] locked env with dummy vision: built and reset at B={batch} in "
          f"{time.perf_counter() - t0:.2f} s; cache {sorted(cache)}, vision_goal "
          f"{tuple(obs['vision_goal'].shape)} {obs['vision_goal'].dtype}, "
          f"{obs['vision_goal'].numel() * 2 / 1e6:.1f} MB of images an observation")
    return env, state


def check_images(label, obs, batch, size=200):
    for k in ("vision", "vision_goal"):
        v = obs[k]
        check(tuple(v.shape) == (batch, 3, size, size, 3) and v.dtype == torch.uint8,
              f"{label}: {k} {tuple(v.shape)} {v.dtype}")
        check(not bool(v.any()), f"{label}: {k} not zero")


def vision_env_steps(env, state, out, steps=VISION_STEPS):
    """`steps` LockedEnv.step calls with dummy vision, actions uniform in
    [-1, 1]; one env in 8 holds a pending success before the first step,
    so its goal resamples there. The goal images' provider is counted: it
    must read exactly the envs that resample, and a step with none must
    carry the cached goal images over as the same tensor. Puts the reads,
    the resamples a step and the last state into `out`. Returns the last
    physics state."""
    from robogym_torch.observation import common as obs_common

    B = state.t.shape[0]
    pending = torch.zeros(B, dtype=torch.bool, device=env.device)
    pending[::8] = True
    state = state.replace(tracker=state.tracker.replace(success_and_no_goal_reset=pending))
    stack = env.obs_stack
    provider = stack.providers["goal_dummy_vision"]
    reads = []

    def counting(e, s):
        reads.append(s.physics.qpos.shape[0])
        return provider.read(e, s)

    env.obs_stack = obs_common.ObservationStack(dict(
        stack.providers, goal_dummy_vision=dataclasses.replace(provider, read=counting)))
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    resampled = []
    try:
        for _ in range(steps):
            before = state.goal_aux[1]["goal_dummy_vision"]["vision_goal"]
            goals = state.tracker.goals_so_far
            n_reads = len(reads)
            action = torch.rand((B, env.action_size), generator=gen, device=env.device) * 2 - 1
            state, obs, reward, _, _ = env.step(state, action)
            n = int((state.tracker.goals_so_far != goals).sum())
            resampled.append(n)
            new_reads = reads[n_reads:]
            check(new_reads == ([n] if n else []),
                  f"locked_dummy_vision_env: goal images read for {new_reads} envs, {n} resampled")
            after = state.goal_aux[1]["goal_dummy_vision"]["vision_goal"]
            check((after is before) == (n == 0),
                  f"locked_dummy_vision_env: goal images copied with {n} envs resampling")
            check_images("locked_dummy_vision_env step", obs, B)
            check(bool(torch.isfinite(reward).all()), "locked_dummy_vision_env: non-finite reward")
    finally:
        env.obs_stack = stack
    check(resampled[0] >= int(pending.sum()), f"locked_dummy_vision_env: resamples {resampled}")
    out.update(resampled=resampled, reads=reads, state=state)
    return state.physics


@contextlib.contextmanager
def timed_renders(out):
    """Inside, every `observation.vision.render_cameras` call is timed on
    the device (synchronized before and after) into out["render_s"], and
    the renderer's env chunks are kept in out["chunks"]."""
    from robogym_torch.observation import vision as vision_lib
    from robogym_torch.render import raycast

    fn = vision_lib.render_cameras
    out.setdefault("render_s", 0.0)
    out.setdefault("chunks", set())

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn(*args, **kw)
        torch.cuda.synchronize()
        out["render_s"] += time.perf_counter() - t0
        out["chunks"].add((raycast.LAST_CHUNK["envs"], raycast.LAST_CHUNK["batch"]))
        return img

    with patched([((vision_lib, "render_cameras"), timed)]):
        yield out


def env0_images(env, state, cams, size, prefixes):
    """Env 0's images of its own state rendered alone, the geoms of the
    bodies named by `prefixes` hidden: (cameras, S, S, 3) uint8."""
    from robogym_torch.envs import core
    from robogym_torch.observation import vision as vision_lib

    one = torch.zeros(1, dtype=torch.long, device=env.device)
    m = core.take_model_envs(core.apply_model_fields(env.model, state.model_fields), one)
    vis = vision_lib.robot_hidden_mask(m, prefixes) if prefixes else None
    return vision_lib.render_cameras(m, core.data_map(lambda x: x[one], state.physics), cams,
                                     size, geom_visible=vis)[0]


def images_close(label, got, want, share=0.995):
    """uint8 images within 1 level on at least `share` of the pixels."""
    off = (got.int() - want.int()).abs().amax(-1) > 1
    part = float(off.float().mean())
    check(part <= 1.0 - share, f"{label}: {part:.4f} of the pixels part by more than 1 level")
    return part


def pixels_differ(a, b) -> int:
    return int(((a.int() - b.int()).abs().amax(-1) > 8).sum())


def pool_goal_without_cube(env):
    """The real-image env's first pool goal rendered as the pool renders it,
    with the cube hidden too: (cameras, S, S, 3) uint8."""
    from robogym_torch.envs import core
    from robogym_torch.observation import dummy_vision
    from robogym_torch.observation import vision as vision_lib
    from robogym_torch.physics import step

    d = core.data_map(lambda x: x[:1].clone(), env._settled_data)
    qpos = d.qpos.clone()
    qpos[:, torch.as_tensor(env.cube.cube_rot_qpos, device=env.device)] = env.pool_quats[:1]
    d = step.fwd_position(env.model, d.replace(qpos=qpos))
    hide = vision_lib.robot_hidden_mask(env.model, ("target:", "robot0:", "cube:"))
    return vision_lib.render_cameras(env.model, d, dummy_vision.DEFAULT_CAMERA_NAMES,
                                     env.constants.vision_image_size, geom_visible=hide)[0]


def vision_path_line(name, wall, out, steps, batch, reset_read, **extra):
    """The readings of a vision path, printed: env-steps/s, the renders'
    share of the steps, the renderer's env chunks and the peak device
    memory of the steps (the caller resets the peak before them)."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    read = dict(env_steps=steps, env_steps_per_s=batch * steps / wall,
                render_s=out["render_s"], render_share=out["render_s"] / wall,
                chunks=sorted(out["chunks"]), peak_gb=peak, **reset_read, **extra)
    print(f"[path {name}] {steps} env steps at B={batch}: {wall:.3f} s, "
          f"{read['env_steps_per_s']:.1f} env-steps/s (built in {reset_read['build_s']:.2f} s, "
          f"reset in {reset_read['reset_s']:.2f} s); renders {out['render_s']:.3f} s, "
          f"{read['render_share']:.3f} of the steps, env chunks {read['chunks']}; peak device "
          f"memory {peak:.2f} GB; {extra}")
    return read


def phase_box_mesh(at, cap):
    """C on a mesh world's box-mesh call (the table's box against the
    meshes: the last but one hull_manifold call of the main sim's last
    substep)."""
    *hargs, hDX = cap["hull_manifold@prev"]
    print(f"[{at}] box-mesh hull_manifold: K={hargs[0].shape[1]}, V1={hargs[0].shape[-1]}, "
          f"V2={hargs[3].shape[-1]}, DX={hDX}")
    check(hDX == 6 and hargs[0].shape[-1] == 8, f"{at}: the box-mesh call is not the table's box")
    return phase_hull("hull_manifold", hargs, hDX, REPS, f"C hull_manifold@{at}-box")


def real_image_env_reset(batch):
    """The real-image locked env (`locked_real_image.make_env`,
    LOCKED_REAL_IMAGE_CONFIG) on the dactyl-shaped world with the vision
    cameras, built and reset at `batch` envs: (env, state, readings).
    Checks the images: (B, 3, S, S, 3) uint8; env 0's `vision` against
    the same env rendered alone, showing the cube and the hand (hiding
    either changes the image); its `vision_goal` the pool's first image,
    which shows the cube; each env's cameras and lights its own."""
    from robogym_torch.envs.dactyl import locked_real_image
    from robogym_torch.observation import dummy_vision

    cams = dummy_vision.DEFAULT_CAMERA_NAMES
    size = LOCKED_REAL_IMAGE_CONFIG["vision_image_size"]
    t0 = time.perf_counter()
    with MEMO.construction("real-image env"):
        env = locked_real_image.make_env(LOCKED_REAL_IMAGE_CONFIG, device="cuda", seed=SEED)
    build_s = time.perf_counter() - t0
    rend = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_renders(rend):
        state, obs = env.reset(batch)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    for k in ("vision", "vision_goal"):
        v = obs[k]
        check(tuple(v.shape) == (batch, len(cams), size, size, 3) and v.dtype == torch.uint8,
              f"locked_real_image reset: {k} {tuple(v.shape)} {v.dtype}")
    check(bool((state.goal["goal_idx"] == 0).all()), "locked_real_image reset: goal_idx not 0")
    alone = env0_images(env, state, cams, size, ("target:",))
    part = images_close("locked_real_image reset: env 0 alone vs batched", obs["vision"][0], alone)
    no_cube = env0_images(env, state, cams, size, ("target:", "cube:"))
    no_hand = env0_images(env, state, cams, size, ("target:", "robot0:"))
    cube_px, hand_px = pixels_differ(alone, no_cube), pixels_differ(alone, no_hand)
    check(cube_px > 100 and hand_px > 100,
          f"locked_real_image reset: the cube ({cube_px} px) or the hand ({hand_px} px) not seen")
    check(torch.equal(obs["vision_goal"][0], env.pool_images[0]),
          "locked_real_image reset: vision_goal is not the pool's first image")
    pool_px = pixels_differ(env.pool_images[0], pool_goal_without_cube(env))
    check(pool_px > 100, f"locked_real_image: the pool's first goal image shows no cube "
          f"({pool_px} px)")
    fov = state.model_fields["cam_fovy"]
    check(bool((fov != fov[:1]).any()), "locked_real_image reset: cameras equal across envs")
    read = dict(build_s=build_s, reset_s=reset_s, render_s_reset=rend["render_s"],
                chunks_reset=sorted(rend["chunks"]), peak_gb_reset=torch.cuda.max_memory_allocated() / 1e9,
                env0_parting_share=part, cube_pixels=cube_px, hand_pixels=hand_px,
                pool_cube_pixels=pool_px)
    print(f"[state] locked_real_image env: built in {build_s:.2f} s (a pool of "
          f"{env.pool_images.shape[0]} goals rendered), reset at B={batch} in {reset_s:.2f} s "
          f"(renders {rend['render_s']:.2f} s, env chunks {sorted(rend['chunks'])}, peak "
          f"{read['peak_gb_reset']:.2f} GB); env 0 alone vs batched: {part:.5f} of pixels part; "
          f"hiding the cube changes {cube_px} px, the hand {hand_px} px; cameras' fovy "
          f"{float(fov.min()):.3f} to {float(fov.max()):.3f}")
    return env, state, read


def real_image_steps(env, state, out, steps=REAL_IMAGE_STEPS):
    """`steps` steps of the real-image env, actions uniform in [-1, 1]; one
    env in 8 holds a pending success, so its goal advances to the pool's
    next; the served goal image is the pool's at each env's `goal_idx`.
    Puts the renders' time and chunks, the advances and the last state
    into `out`. Returns the last physics state."""
    B = state.t.shape[0]
    pending = torch.zeros(B, dtype=torch.bool, device=env.device)
    pending[::8] = True
    state = state.replace(tracker=state.tracker.replace(success_and_no_goal_reset=pending))
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    advanced = []
    with timed_renders(out):
        for _ in range(steps):
            idx = state.goal["goal_idx"]
            action = torch.rand((B, env.action_size), generator=gen, device=env.device) * 2 - 1
            state, obs, reward, _, _ = env.step(state, action)
            moved = state.goal["goal_idx"] != idx
            advanced.append(int(moved.sum()))
            check(bool((state.goal["goal_idx"][moved] == (idx[moved] + 1) % env.pool_quats.shape[0])
                       .all()), "locked_real_image_env: a goal did not advance to the next")
            check(torch.equal(obs["vision_goal"], env.pool_images[state.goal["goal_idx"]]),
                  "locked_real_image_env: vision_goal is not the pool's image at goal_idx")
            check(bool(torch.isfinite(reward).all()), "locked_real_image_env: non-finite reward")
    check(advanced[0] >= int(pending.sum()), f"locked_real_image_env: advances {advanced}")
    out.update(advanced=advanced, state=state)
    return state.physics


def rearrange_vision_reset(batch):
    """The blocks env with vision (REARRANGE_VISION_CONFIG: front and wrist
    cameras, vision randomization, every stand-in material, block goal
    rotations, the icp distance) on the UR16e-shaped world with the vision
    cameras, built and reset at `batch` envs: (env, state, readings).
    Checks the three image keys' shapes, env 0's `vision_obs` against the
    same env rendered alone and that hiding the blocks changes it, and
    that the materials' and the cameras' fields vary across envs on their
    rows."""
    from robogym_torch.envs.rearrange import blocks

    cst, par = REARRANGE_VISION_CONFIG
    size = cst.get("vision_image_size", 200)
    t0 = time.perf_counter()
    with MEMO.construction("rearrange vision env"):
        env = blocks.make_env(cst, par, device="cuda", seed=SEED)
    build_s = time.perf_counter() - t0
    rend = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_renders(rend):
        state, obs = env.reset(batch)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    ncam = {"vision_obs": len(env.constants.vision_camera_names),
            "vision_obs_mobile": len(env.constants.vision_mobile_camera_names),
            "vision_goal": len(env.constants.vision_camera_names)}
    for k, n in ncam.items():
        v = obs[k]
        check(tuple(v.shape) == (batch, n, size, size, 3) and v.dtype == torch.uint8,
              f"rearrange_vision reset: {k} {tuple(v.shape)} {v.dtype}")
    cams = env.constants.vision_camera_names
    alone = env0_images(env, state, cams, size, ())
    part = images_close("rearrange_vision reset: env 0 alone vs batched", obs["vision_obs"][0],
                        alone)
    objects = tuple(f"object{i}" for i in range(env.num_objects))
    blocks_px = pixels_differ(alone, env0_images(env, state, cams, size, objects))
    check(blocks_px > 50, f"rearrange_vision reset: the blocks not seen ({blocks_px} px)")
    goal_px = pixels_differ(obs["vision_obs"][0], obs["vision_goal"][0])
    check(goal_px > 0, "rearrange_vision reset: the goal image is the live one")
    gids = torch.as_tensor(env.idx.object_geom_ids, device=env.device)
    spread = {}
    for k in ("geom_friction", "geom_margin", "geom_solref", "body_mass", "cam_fovy", "cam_pos",
              "light_pos"):
        v = state.model_fields[k]
        if k.startswith("geom"):
            v = v[:, gids]
        elif k == "body_mass":
            v = v[:, torch.as_tensor(env.idx.object_body_ids, device=env.device)]
        spread[k] = float((v - v[:1]).abs().max())
        check(spread[k] > 0, f"rearrange_vision reset: {k} equal across envs")
    read = dict(build_s=build_s, reset_s=reset_s, render_s_reset=rend["render_s"],
                chunks_reset=sorted(rend["chunks"]), peak_gb_reset=torch.cuda.max_memory_allocated() / 1e9,
                env0_parting_share=part, blocks_pixels=blocks_px, goal_pixels=goal_px,
                field_spread=spread, materials=list(env._material_table.names))
    print(f"[state] rearrange vision env: built in {build_s:.2f} s, reset at B={batch} in "
          f"{reset_s:.2f} s (renders {rend['render_s']:.2f} s, env chunks "
          f"{sorted(rend['chunks'])}, peak {read['peak_gb_reset']:.2f} GB); env 0 alone vs "
          f"batched: {part:.5f} of pixels part; hiding the blocks changes {blocks_px} px; "
          f"materials {read['materials']}; fields' spread across envs {spread}")
    return env, state, read


def reach_agreement(env, state, n=64):
    """One substep of the reach env's physics on the first n envs of the
    reach path's last state (its controls), through the kernels and
    through the plain versions: qpos to 1e-4 abs, qvel to 1e-3 of its
    largest value, as the five worlds."""
    from robogym_torch.envs import core
    from robogym_torch.physics import step

    d = core.data_map(lambda x: x[:n], state.physics)
    got = step.step(env.model, d)
    with plain_versions():
        want = step.step(env.model, d)
    torch.cuda.synchronize()
    for k in ("qpos", "qvel"):
        g, w = getattr(got, k), getattr(want, k)
        e = float((g - w).abs().max())
        tol = 1e-4 if k == "qpos" else 1e-3 * float(w.abs().max())
        print(f"[whole step] reach, B={n} one substep, kernels vs plain versions: {k} max abs "
              f"err {e:.3g} (tol {tol:.3g})")
        check(bool(torch.isfinite(g).all()) and e <= tol,
              f"whole step reach: {k} differs by {e:.3g} > {tol:.3g}")


def rearrange_env_reset(batch, module="blocks", config=REARRANGE_CONFIG,
                        label="rearrange blocks env", draws_out=None, worlds=None):
    """An env of the rearrange blocks family on the card as its `make_env`
    builds it (`envs/rearrange/<module>.make_env(*config)`; by default
    bench.py's blocks env: 8 object slots, 5 blocks, the default TCP control
    through the mocap_ik dual sim; its construction runs the
    arm-to-tabletop settle, 200 substeps at B=1), on the compiled `worlds`
    where given, and its reset at `batch` envs (`rearrange_reset`): (env,
    state, seconds built, seconds reset)."""
    make_env = importlib.import_module("robogym_torch.envs.rearrange." + module).make_env
    t0 = time.perf_counter()
    with MEMO.construction(label):
        env = make_env(*config, device="cuda", seed=SEED, worlds=worlds)
    built = time.perf_counter() - t0
    state, reset = rearrange_reset(env, batch, label, built, draws_out)
    return env, state, built, reset


def compiled_rearrange_worlds(config=REARRANGE_CONFIG):
    """The worlds of the blocks env of `config`, compiled on the card's host
    by `blocks.compile_worlds` as the JAX env compiles them at its
    construction, the base world from the stand-in's builder
    (`rearrange_blocks_like.world_xml_builder`), each held to its committed
    snapshot (`hold_to_snapshot`): ({name: Model}, seconds)."""
    from robogym_torch.envs.rearrange import blocks
    from robogym_torch.worlds import rearrange_blocks_like

    t0 = time.perf_counter()
    cst, par = blocks.configs(*config)
    with tempfile.TemporaryDirectory() as tmp:
        worlds = blocks.compile_worlds(cst, par, "cuda",
                                       rearrange_blocks_like.world_xml_builder(tmp))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snaps = {"model": rearrange_blocks_like.SNAPSHOT,
             "solver_model": rearrange_blocks_like.SOLVER_SNAPSHOT}
    check(sorted(worlds) == sorted(snaps), f"compile_worlds gave {sorted(worlds)}")
    ruled = {k: hold_to_snapshot(f"compile_worlds {k}", worlds[k], path)
             for k, path in snaps.items()}
    print(f"[compile] the rearrange env's worlds by compile_worlds: {sorted(worlds)} in "
          f"{secs:.2f} s; against the snapshots "
          + ("every field equal" if not any(ruled.values()) else f"held by meaning: {ruled}"))
    return worlds, secs


def rearrange_reset(env, batch, label, built, draws_out=None):
    """The reset of a built rearrange env at `batch` envs from its seed
    (group scan, placement, the object settle of `stabilize_steps` env steps, the first
    goal): (state, seconds). Checks the state, the solver sim's and the
    observations finite. The reset's draws go into `draws_out` where
    given."""
    from robogym_torch.envs.rearrange import simulation

    t1 = time.perf_counter()
    draws = env.draw_reset(batch)
    state, obs = env.reset(batch, draws)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if draws_out is not None:
        draws_out.update(draws)
    c, sc = env.model.const, env.solver_model.const
    on_table = 1.0 - float(simulation.check_objects_off_table(
        env.idx, simulation.object_positions(env.idx, state.physics),
        active_mask=env._active).any(-1).float().mean())
    print(f"[state] {label} on the UR16e-shaped world (nv={c.nv}, {c.neq} "
          f"equalities; solver world nv={sc.nv}, {sc.neq} equalities; goals "
          f"{type(env.goal_gen).__name__}): built (its settle, "
          f"{5 * env.constants.mujoco_substeps} substeps at B=1) in {built:.2f} s; reset at "
          f"B={batch} ({env.constants.stabilize_steps * env.constants.mujoco_substeps} "
          f"substeps of object settle) in {t2 - t1:.2f} s; every object on the table in "
          f"{on_table:.4f} of envs")
    for d, name in ((state.physics, "main"), (state.goal_aux, "solver")):
        for k in ("qpos", "qvel", "qacc"):
            check(bool(torch.isfinite(getattr(d, k)).all()),
                  f"{label} reset: non-finite {name} {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"{label} reset: non-finite obs {k}")
    return state, t2 - t1


def blocks_train_readings(env, state):
    """blocks_train's reset state: the settle world's size and budgets, each
    env's block sizes, the goals' heights and placement masks. Returns the
    spread of the block sizes across envs."""
    from robogym_torch.envs.rearrange import simulation

    sc = env._settle_model.const
    size = state.model_fields["geom_size"][:, torch.as_tensor(env.idx.object_geom_ids)]
    z = state.goal["obj_pos"][..., 2]
    _, _, table_h = env.idx.table_dimensions()
    lifted = ((z > table_h + 0.06) & env._active).any(-1)
    inside = state.goal["goal_objects_in_placement_area"].float().mean()
    print(f"[state] blocks_train: settle world nv={sc.nv}, ncon_active "
          f"{env._settle_model.opt.ncon_active}, group_cap {env._settle_model.opt.group_cap}; "
          f"block half-sizes {float(size.min()):.5f} to {float(size.max()):.5f} m; first goals "
          f"settled, z {float(z.min()):.4f} to {float(z.max()):.4f} m, an object above the table's "
          f"first layer in {float(lifted.float().mean()):.4f} of envs, goal objects in the "
          f"placement area (soft mask) {float(inside):.4f}")
    check(float(size.max() - size.min()) > 1e-3, "blocks_train: the cuboids do not differ")
    check(not bool(simulation.check_objects_off_table(
        env.idx, state.goal["obj_pos"], active_mask=env._active).any()),
          "blocks_train: a settled goal off the table")
    return float((size.amax(0) - size.amin(0)).max())


def rearrange_actions(env, batch):
    """A seeded generator of actions uniform in [-1, 1] (B, action_size),
    as bench.py drives the JAX env."""
    gen = torch.Generator(device=env.device)
    gen.manual_seed(SEED)
    return lambda: torch.rand((batch, env.action_size), generator=gen,
                              device=env.device) * 2.0 - 1.0


def capture_ends(targets, run, last=1):
    """The arguments of the first and the `last` last calls of each
    `module.<name>` of `targets` while `run()` runs: {name: (first, ...,
    last)}. The tensors are the calls' own, not copies, so that recording
    adds nothing to a timed path: the kernels' wrappers write only tensors
    they allocate, and no caller writes into an argument after its call
    (the CPU tests hold this record to one of copies, bit for bit)."""
    store = {}

    def recorder(name, fn):
        def rec(*args):
            calls = store.setdefault(name, [args] * (1 + last))
            calls[1:] = calls[2:] + [args]
            return fn(*args)
        return rec

    with patched([((module, name), recorder(name, getattr(module, name)))
                  for module, name in targets]):
        run()
    for _, name in targets:
        check(name in store, f"{name} was not called")
    return store


def one_step(env, state):
    """One env step of a rearrange env from `state`, the seeded first
    actions (`rearrange_actions`): the step a path's first step takes."""
    act = rearrange_actions(env, state.t.shape[0])()
    return lambda: env.step(state, act)


def captured(capture, run, store):
    """`run` for `drive` that records its kernels' inputs: it returns
    run()'s value and puts into store["cap"] what `capture(r)` records of
    the run r (`capture_rearrange` or `capture_family_step` given `run=`).
    The inputs a path's one step records are those of `one_step`."""
    def go():
        result = []
        store["cap"] = capture(lambda: result.append(run()))
        return result[0]
    return go


def capture_rearrange(env, state, kernels=("hull_manifold", "hull_pair", "boxbox"), run=None):
    """The kernels' inputs in one rearrange env step from `state` (or in
    `run`, a path's one step from it): the solver sim's come first in a
    step (its fwd_position, then its substeps), the main sim's last.
    Returns {"main" and "solver": (core inputs, CG iterations, facets per
    contact), the main sim's last substep's arguments of each of
    `kernels`, and under "<kernel>@first" and "<kernel>@prev" the step's
    first call's (the solver's fwd_position) and the last but one call's}."""
    from robogym_torch.physics import constraint_batched
    from robogym_torch.physics.collision import boxbox_kernel, convex_kernel

    calls = capture_ends([(constraint_batched, "fused_step_core")]
                         + [(boxbox_kernel if k == "boxbox" else convex_kernel, k)
                            for k in kernels], run or one_step(env, state), last=2)
    out = {name: calls[name][2] for name in kernels}
    out.update({name + "@first": calls[name][0] for name in kernels})
    out.update({name + "@prev": calls[name][1] for name in kernels})
    for key, (kind_s, iterations, nfacet, *args) in zip(("solver", "main"),
                                                         calls["fused_step_core"][::2]):
        out[key] = (constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet)
    return out


def capture_family_step(env, state, run=None):
    """The kernels' inputs in one env step of a rearrange family env from
    `state` (or in `run`, a path's one step from it): the last
    `fused_step_core` and `boxbox` calls of the step (a
    blocks_train step's come from its goal settle, which runs last; a
    dominos step's from its main sim's last substep), as (core inputs, CG
    iterations, facets per contact) and the box-box arguments; and, where
    the env settles goals, the settle world's last state."""
    from robogym_torch.physics import constraint_batched
    from robogym_torch.physics import step as step_lib
    from robogym_torch.physics.collision import boxbox_kernel

    settled, step_n = {}, step_lib.step_n

    def recorded(m, d, n):
        out = step_n(m, d, n)
        if m is env._settle_model:
            settled["data"] = out
        return out

    with patched([((step_lib, "step_n"), recorded)]):
        calls = capture_ends([(constraint_batched, "fused_step_core"),
                              (boxbox_kernel, "boxbox")], run or one_step(env, state))
    kind_s, iterations, nfacet, *args = calls["fused_step_core"][1]
    return (constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet,
            calls["boxbox"][1], settled.get("data"))


def settle_budget_reading(env, d):
    """The goal settle's contact budget at its last substep: live contacts
    per env against `ncon_active` (the rows beyond it are dropped, as the
    JAX package drops them)."""
    live = d.contact.active.sum(1)
    cap = env._settle_model.opt.ncon_active
    over = live > cap
    print(f"[settle8] the goal settle's last substep, B={live.shape[0]}: live contacts per env "
          f"mean {float(live.float().mean()):.2f}, max {int(live.max())}; above ncon_active="
          f"{cap} (rows dropped) in {float(over.float().mean()):.4f} of envs")
    return dict(live_mean=float(live.float().mean()), live_max=int(live.max()),
                dropped_share=float(over.float().mean()))


def goal_generator_checks(tenv, tstate, denv, batch):
    """The goal generators of the family's other envs (reach, det-reach,
    stack, pick-and-place, attached, duplicate, dominos under is_holdout,
    wordblocks) on the card at `batch` envs, each from its own draws, on the
    blocks_train env's world and reset state (dominos on the dominos env's,
    wordblocks on its 6-block world's index): every goal finite, every
    active object's goal on the table (det-reach's first object at one of
    its two pool positions). Prints each one's goal heights and time."""
    from robogym_torch.envs.rearrange import (blocks_attached, goals, simulation,
                                              wordblocks)
    from robogym_torch.worlds import rearrange_blocks_like

    idx, arm, d = tenv.idx, tenv.robot.arm, tstate.physics
    word_m, _ = load_world(rearrange_blocks_like.WORDBLOCKS_SNAPSHOT)
    word_idx = simulation.RearrangeIndex.build(word_m, rearrange_blocks_like.WORDBLOCKS_OBJECTS)
    cases = {
        "reach": (goals.ObjectReachGoal(idx, arm), tenv, 1),
        "det-reach": (goals.DeterministicReachGoal(idx, arm), tenv, 1),
        "stack": (goals.ObjectStackGoal(idx, fixed_order=False), tenv, 2),
        "pickandplace": (goals.PickAndPlaceGoal(idx), tenv, 5),
        "attached": (blocks_attached.AttachedBlockStateGoal(idx), tenv, 8),
        "duplicate": (goals.ObjectStateGoal(idx), tenv, 5),
        "dominos-holdout": (goals.DominoStateGoal(denv.idx, goals.GoalArgs(rot_dist_type="mod180")),
                            denv, 5),
        "wordblocks": (wordblocks.goal_generator(word_idx), None, 6),
    }
    out = {}
    for name, (gen, env, n) in cases.items():
        gidx = gen.idx
        active = torch.arange(gidx.max_num_objects, device=d.qpos.device) < n
        model = env.model if env is not None else word_m
        sizes = simulation.geom_bbox_half(model, gidx.object_geom_ids)
        g = torch.Generator(device=d.qpos.device)
        g.manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        goal = gen.next_goal(gen.draw(g, batch, n, d.qpos.device), active, sizes, n, d)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        pos = goal["obj_pos"]
        check(all(bool(torch.isfinite(v).all()) for v in goal.values() if v.is_floating_point()),
              f"goal generator {name}: non-finite goal")
        on = active.clone()
        if name == "det-reach":
            pool = torch.as_tensor(gen.ALL_POSITIONS, dtype=pos.dtype, device=pos.device)
            check(bool((pos[:, :1, None] - pool).abs().amax(-1).amin(-1).le(1e-6).all()),
                  "goal generator det-reach: slot 0 not at a pool position")
            on[0] = False
        _, _, table_h = gidx.table_dimensions()
        off = simulation.check_objects_off_table(gidx, pos, active_mask=on)
        low = (pos[..., 2] < table_h - 1e-4) & on
        check(not bool((off | low).any()), f"goal generator {name}: an active goal off the table")
        z = pos[..., 2][:, active]
        print(f"[goals] {name} ({type(gen).__name__}), B={batch}, {n} objects: goal z "
              f"{float(z.min()):.4f} to {float(z.max()):.4f} m, finite and on the table; "
              f"{ms:.2f} ms with its draws")
        out[name] = dict(ms=ms, z_min=float(z.min()), z_max=float(z.max()))
    return out


def rearrange_env_steps(env, state, out, steps, label="rearrange_env", per_step=None):
    """`steps` env steps of a rearrange env from `state`, actions uniform in
    [-1, 1]; checks every obs and reward finite, and puts the reward sum by
    component, the episodes done, the envs with a block off the table, the
    share of envs with gripper-table contact and the last state into
    `out`; `per_step(state)` reads each step's state. Returns the last
    physics state."""
    actions = rearrange_actions(env, state.t.shape[0])
    rewards, done, off, contact, finite = 0.0, 0, 0, 0.0, {}
    for _ in range(steps):
        state, obs, reward, dn, info = env.step(state, actions())
        if per_step is not None:
            per_step(state)
        for k, v in dict(obs, reward=reward).items():   # read after the run: no sync here
            ok = torch.isfinite(v).all()
            finite[k] = finite[k] & ok if k in finite else ok
        for k in ("qpos", "qvel", "qacc"):
            ok = torch.isfinite(getattr(state.goal_aux, k)).all()
            finite["solver " + k] = finite["solver " + k] & ok if "solver " + k in finite else ok
        rewards = rewards + reward.sum(0)
        done = done + dn.sum()
        off = off + info["objects_off_table"].any(-1).sum()
        contact = contact + info["gripper_table_contact"].float().mean()
    for k, ok in finite.items():
        check(bool(ok), f"{label} path: non-finite {k}")
    out.update(reward_sum=[float(x) for x in rewards], done=int(done),
               off_table=int(off), table_contact=float(contact) / steps, state=state)
    return state.physics


def rearrange_agreement(env, state, n=64, label="rearrange", path="rearrange_env", solver=True):
    """One substep of each rearrange world, the main sim (each env's own
    model fields) and, with `solver`, the solver sim, on the first n envs
    of the path's last state, through the kernels against the plain
    versions: qpos to 1e-4 abs, qvel to 1e-3 of its largest value (the
    whole-step agreement of the other worlds)."""
    from robogym_torch.envs import core
    from robogym_torch.physics import step

    fields = {k: v[:n] for k, v in (state.model_fields or {}).items()}
    worlds = [(label, core.apply_model_fields(env.model, fields), state.physics)]
    if solver:
        worlds.append(("solver", env.solver_model, state.goal_aux))
    for name, m, d in worlds:
        d = core.data_map(lambda x: x[:n], d)
        got = step.step(m, d)
        with plain_versions():
            want = step.step(m, d)
        torch.cuda.synchronize()
        for k in ("qpos", "qvel"):
            g, w = getattr(got, k), getattr(want, k)
            e = float((g - w).abs().max())
            tol = 1e-4 if k == "qpos" else 1e-3 * float(w.abs().max())
            print(f"[whole step] {name}, B={n} one substep of the {path} path's last "
                  f"state, kernels vs plain versions: {k} max abs err {e:.3g} (tol {tol:.3g})")
            check(bool(torch.isfinite(g).all()) and e <= tol,
                  f"whole step {name}: {k} differs by {e:.3g} > {tol:.3g}")


def group_slots(model):
    """{(kind, type 1, type 2, contacts a pair): the group's contact slots}
    of a world's collision groups, in the Contact's row order."""
    from robogym_torch.physics.collision import driver

    out, base = {}, 0
    for g in driver.build_groups(model.const, model.opt.group_cap):
        n = g["K"] * g["ncon"]
        out[(g["kind"], int(g["t1"]), int(g["t2"]), g["ncon"])] = slice(base, base + n)
        base += n
    return out


def live_pairs(model, d, groups):
    """Live contacts of each group of `groups` (keys of `group_slots`)
    summed over the batch (a device tensor each: no sync)."""
    slots = group_slots(model)
    return {key: d.contact.active[:, slots[key]].sum() for key in groups}


def mesh_groups(model):
    """The YCB world's mesh-mesh group of free bodies (4-point manifold)
    and its box-mesh group."""
    from robogym_torch.mjcf.model import GeomType

    return [(k, t1, t2, n) for k, t1, t2, n in group_slots(model)
            if (k, t1, t2, n) in (("convex", GeomType.MESH, GeomType.MESH, 4),
                                  ("box_convex", GeomType.BOX, GeomType.MESH, 4))]


def ycb_readings(env, state, label):
    """The YCB env's reset state: each slot's candidate by env (read back
    from each env's hulls), the mesh rows of `mesh_convex_vert` that vary
    across envs (they must be exactly the object slots' meshes), each
    env's masses. Returns the readings."""
    fields = state.model_fields
    mv = fields["mesh_convex_vert"]                                       # (B, nmesh, V, 3)
    mids = torch.as_tensor(env._slot_mesh_ids, device=mv.device)
    hit = (mv[:, mids][:, :, None] == env.bank.hull_vert[None, None]).all(-1).all(-1)
    check(bool((hit.sum(-1) >= 1).all()), f"{label}: a slot's hull is no candidate's")
    cand = hit.float().argmax(-1)                                         # (B, O)
    hist = [[int((cand[:, o] == c).sum()) for c in range(env.bank.num_candidates)]
            for o in range(env.max_num_objects)]
    varies = (mv != mv[:1]).flatten(2).any(-1).any(0)
    rows = sorted(int(i) for i in torch.nonzero(varies).flatten())
    check(rows == sorted(env._slot_mesh_ids.tolist()),
          f"{label}: mesh_convex_vert varies on mesh rows {rows}, want the slots' "
          f"{sorted(env._slot_mesh_ids.tolist())}")
    print(f"[state] {label}: candidates {list(env.bank.names)}; per slot, the envs that drew "
          f"each: {hist}; mesh_convex_vert varies across envs on exactly the {len(rows)} slot "
          f"meshes {rows} of {mv.shape[1]}; per-env mesh table {mv.numel() * 4 / 1e6:.1f} MB")
    return dict(candidate_histogram=hist, varying_mesh_rows=rows)


def ycb_stabilized_steps(env, state, out):
    """One step of the YCB env under `stabilize_goal` from `state`, one env
    in 8 holding a pending success, actions uniform in [-1, 1]. The goal
    settle must run once, on exactly the resampling envs; exactly their
    goals change, finite, the others' stay. Puts the settle's seconds,
    the envs it ran on and the last state into `out`. Returns the last
    physics state."""
    B = state.t.shape[0]
    pending = torch.zeros(B, dtype=torch.bool, device=env.device)
    pending[::8] = True
    state = state.replace(tracker=state.tracker.replace(success_and_no_goal_reset=pending))
    settles, envs, secs = env.goal_settles, env.goal_settle_envs, []
    settle = env._settle_in_model

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = settle(*args, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return res

    goals = state.tracker.goals_so_far
    before = dict(state.goal)
    env._settle_in_model = timed
    try:
        state, obs, reward, _, _ = env.step(state, rearrange_actions(env, B)())
    finally:
        del env._settle_in_model
    new = state.tracker.goals_so_far != goals
    n = int(new.sum())
    check(bool(new[pending].all()) and env.goal_settles - settles == 1
          and env.goal_settle_envs - envs == n,
          f"ycb_stabilized_env: {n} goals resampled, {env.goal_settles - settles} settles on "
          f"{env.goal_settle_envs - envs} envs, {int(pending.sum())} pending")
    for k in ("obj_pos", "obj_rot"):
        v = state.goal[k]
        check(bool((v[~new] == before[k][~new]).all()), f"ycb_stabilized_env: kept goal {k} moved")
        check(bool((v[new] != before[k][new]).flatten(1).any(-1).all()),
              f"ycb_stabilized_env: a resampled goal {k} did not change")
        check(bool(torch.isfinite(v[new]).all()), f"ycb_stabilized_env: resampled {k} not finite")
    for k, v in dict(obs, reward=reward).items():
        check(bool(torch.isfinite(v).all()), f"ycb_stabilized_env: non-finite {k}")
    out.update(settle_s=secs[0], settled_envs=n, state=state)
    return state.physics


def stabilized_copy(env):
    """The YCB env under `stabilize_goal` on the construction of `env` (the
    same worlds, bank and settled start: only the goal's arguments
    differ), its goal settle `GOAL_SETTLE_SUBSTEPS` substeps
    (`OLDER_STABILIZE_STEPS`)."""
    out = copy.copy(env)
    args = dataclasses.replace(env.goal_gen.args, stabilize_goal=True)
    out.goal_gen = copy.copy(env.goal_gen)
    out.goal_gen.args = args
    out.constants = dataclasses.replace(env.constants, goal_args=tuple(sorted(
        dataclasses.asdict(args).items())), stabilize_steps=OLDER_STABILIZE_STEPS)
    out.goal_settles = out.goal_settle_envs = 0
    return out


def family_readings(name, env, state, draws):
    """A mesh-family env's reset state: every object on the table; the
    fixed goals (table setting, chessboard) at their fractions of the
    placement area, equal in every env, at their rotations; the mixture's
    datasets each drawn and no candidate of weight 0 under its env's
    dataset; the composer's `geom_pos` differing across envs on exactly its
    sub-geoms past the roots. Returns the readings."""
    from robogym_torch.envs.rearrange import chessboard, simulation, table_setting

    pos = simulation.object_positions(env.idx, state.physics)
    off = simulation.check_objects_off_table(env.idx, pos, active_mask=env._active).any(-1)
    n_off = int(off.sum())
    check(n_off == 0, f"{name} reset: {n_off} envs with an object off the table")
    out = {"envs_with_an_object_off_the_table": n_off}
    if name in ("table_setting", "chessboard"):
        O = env.max_num_objects
        frac = (table_setting.RELATIVE_PLACEMENTS[:O] if name == "table_setting"
                else chessboard.back_rank(O))
        quats = (table_setting.init_quats(O) if name == "table_setting"
                 else np.tile([1.0, 0.0, 0.0, 0.0], (O, 1)))
        lo, hi = env.idx.placement_bounds(env.num_objects,
                                          env.parameters.simulation_params.used_table_portion)
        want = torch.as_tensor(lo[:2] + frac * (hi[:2] - lo[:2]))
        g = state.goal
        xy_err = float((g["obj_pos"][..., :2].double().cpu() - want).abs().max())
        rot_err = float((g["obj_rot"].double().cpu() - torch.as_tensor(quats)).abs().max())
        same = bool((g["obj_pos"] == g["obj_pos"][:1]).all()
                    and (g["obj_rot"] == g["obj_rot"][:1]).all())
        print(f"[state] {name}: fixed goals, the same in every env: {same}; (x, y) vs the "
              f"placement area's fractions max abs {xy_err:.3g} m; rotations vs theirs "
              f"{rot_err:.3g}")
        check(same and xy_err <= 1e-6 and rot_err <= 1e-6, f"{name}: goals not at the placements")
        out.update(goal_xy_err=xy_err, goal_rot_err=rot_err)
    if name == "mixture":
        ds, cand = draws["ds"], draws["cand"]
        w = torch.as_tensor(env.candidate_weights, device=ds.device)
        drawn = [int((ds == i).sum()) for i in range(len(env.dataset_names))]
        zero = int((w[ds[:, None], cand] <= 0).sum())
        print(f"[state] mixture: envs of each dataset {dict(zip(env.dataset_names, drawn))}; "
              f"candidates {list(env.bank.names)}; drawn at weight 0: {zero}")
        check(all(n > 0 for n in drawn) and zero == 0, f"mixture draws: {drawn}, {zero} at 0")
        out.update(dataset_envs=drawn)
    if name == "composer":
        gp = state.model_fields["geom_pos"]
        varies = sorted(int(i) for i in torch.nonzero((gp != gp[:1]).any(-1).any(0)).flatten())
        sub = sorted(int(g) for g in env._sub_geom_ids[:, 1:].reshape(-1))
        n_geoms = draws["num_geoms"].float()
        print(f"[state] composer: geom_pos varies across envs on geoms {varies} (the sub-geoms "
              f"past the roots: {varies == sub}); sub-geoms a slot, mean "
              f"{float(n_geoms.mean()):.3f}; per-env geom_pos {gp.numel() * 4 / 1e6:.2f} MB")
        check(varies == sub, f"composer: geom_pos varies on {varies}, want {sub}")
        out.update(geom_pos_rows=len(varies))
    return out


def family_live(name, env, d):
    """Live contacts over the batch of the mesh-mesh and box-mesh groups
    (`mesh_groups`); for the composer also its contacts with a sub-geom
    past a root, and those between two objects' geoms (device tensors: no
    sync)."""
    out = live_pairs(env.model, d, mesh_groups(env.model))
    out = {f"{k[0]} {k[1]}-{k[2]}": v for k, v in out.items()}
    if name == "composer":
        c = d.contact
        sub = torch.as_tensor(env._sub_geom_ids[:, 1:].reshape(-1), device=c.geom1.device)
        objs = torch.as_tensor(env._sub_geom_ids.reshape(-1), device=c.geom1.device)
        g1_sub, g2_sub = torch.isin(c.geom1, sub), torch.isin(c.geom2, sub)
        both = torch.isin(c.geom1, objs) & torch.isin(c.geom2, objs) & (c.body1 != c.body2)
        out["sub-geom"] = (c.active & (g1_sub | g2_sub)).sum()
        out["object-object"] = (c.active & both).sum()
    return out


def family_path(name, env, state, out, live):
    """`FAMILY_STEPS` steps of a mesh-family env (`rearrange_env_steps`),
    its live contacts a step into `live`."""
    return rearrange_env_steps(env, state, out, FAMILY_STEPS, name + "_env",
                               per_step=lambda st: live.append(family_live(name, env,
                                                                           st.physics)))


def holdout_env_reset(batch):
    """The stand-in holdout from its jsonnet config (`env_utils.load_env`)
    on the card and its reset at `batch` envs: (env, state, seconds built,
    seconds reset). Checks the state finite, the objects at the saved
    initial state and the goals from the saved goal states."""
    from robogym_torch.envs.rearrange import simulation
    from robogym_torch.utils import env_utils
    from robogym_torch.worlds import holdout_ball_like

    t0 = time.perf_counter()
    with MEMO.construction("holdout env"):
        env = env_utils.load_env(holdout_ball_like.CONFIG,
                                 constants={"stabilize_steps": OLDER_STABILIZE_STEPS},
                                 device="cuda", seed=SEED)
    t1 = time.perf_counter()
    state, obs = env.reset(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    c = env.model.const
    init = torch.as_tensor(env._initial_state["obj_pos"], dtype=env.dtype, device=env.device)
    pos = simulation.object_positions(env.idx, state.physics)
    err = float((pos - init).abs().max())
    gerr = float((state.goal["obj_pos"] - env.goal_gen.pool_pos[0]).abs().max())
    print(f"[state] holdout env from {os.path.basename(holdout_ball_like.CONFIG)} (nv={c.nv}, "
          f"{len(c.collision_pairs)} collision pairs, {env.num_objects} task objects, scene "
          f"bodies {env._scene_bodies}): built in {t1 - t0:.2f} s; reset at B={batch} in "
          f"{t2 - t1:.2f} s; objects vs the saved initial state max abs {err:.3g} m; goals vs "
          f"the saved goal state {gerr:.3g} m")
    check(err <= 1e-6 and gerr <= 1e-6, "holdout reset: not the saved initial and goal states")
    for d, name in ((state.physics, "main"), (state.goal_aux, "solver")):
        for k in ("qpos", "qvel", "qacc"):
            check(bool(torch.isfinite(getattr(d, k)).all()), f"holdout reset: non-finite {name} {k}")
    for k, v in obs.items():
        check(bool(torch.isfinite(v).all()), f"holdout reset: non-finite obs {k}")
    return env, state, t1 - t0, t2 - t1


def round_groups(model):
    """The holdout world's round-geom groups that its stand-in must keep
    live: the ball against the platform (sphere-mesh) and the cylinder
    against the table (cylinder-box)."""
    from robogym_torch.mjcf.model import GeomType

    want = [("convex", GeomType.SPHERE, GeomType.MESH, 1),
            ("convex", GeomType.CYLINDER, GeomType.BOX, 1)]
    have = group_slots(model)
    check(all(k in have for k in want), f"holdout: round-geom groups {want} not all in {list(have)}")
    return want


def script_launches(name, run, kernels):
    """Run an entry point with every launch count set to 0 just before it
    and read just after; check that each of `kernels` was launched.
    Returns (run's value, seconds, launches)."""
    from robogym_torch import cuda

    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    value = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    for k in kernels:
        check(launches.get(k, 0) > 0, f"{name}: {k} was not launched {launches}")
    return value, wall, launches


def frames_readings(label, frames, n):
    """Check replayed frames: (n, H, W, 3) uint8 at REPLAY_SIZE, no frame
    black or of one colour."""
    w, h = REPLAY_SIZE
    check(frames.shape == (n, h, w, 3) and frames.dtype == np.uint8,
          f"{label}: frames {frames.shape} {frames.dtype}, want ({n}, {h}, {w}, 3) uint8")
    flat = frames.reshape(n, -1).astype(np.float64)
    check(bool((flat.max(1) > 0).all() and (flat.std(1) > 0).all()),
          f"{label}: a frame black or of one colour")


def examine_path(tmp):
    """`scripts/examine.py` on the card (`examine.main`, the locked env
    found by its path, EXAMINE_STEPS steps, the trajectory recorded), its
    env's construction shared through `MEMO` with the locked env's (the
    same world and settle); then `viewer.replay_npz` of the record through
    the raycaster, every frame at REPLAY_SIZE, and `EnvReplayViewer(env).run
    (VIEWER_STEPS)` on the same env: readings."""
    from robogym_torch import viewer
    from robogym_torch.envs.dactyl import locked
    from robogym_torch.scripts import examine

    record = os.path.join(tmp, "traj.npz")
    argv = ["dactyl/locked.py", f"num_steps={EXAMINE_STEPS}", f"record={record}",
            f"constants={EXAMINE_CONSTANTS}"]

    def run():
        with constructing(locked, "make_env", "examine env") as made:
            examine.main(argv)
        return made["env"]

    env, wall, launches = script_launches("examine", run, PER_CALL["locked_env"])
    with np.load(record) as z:
        check(sorted(z.files) == ["qpos"] and z["qpos"].shape == (EXAMINE_STEPS + 1,
                                                                   env.model.const.nq),
              f"examine: the record holds {[(k, z[k].shape) for k in z.files]}")
    w, h = REPLAY_SIZE
    t0 = time.perf_counter()
    frames = viewer.replay.replay_npz(env, record, backend="raycast", width=w, height=h)
    replay_s = time.perf_counter() - t0
    frames_readings("replay_npz", frames, EXAMINE_STEPS + 1)
    t0 = time.perf_counter()
    seen = viewer.EnvReplayViewer(env, width=w, height=h).run(VIEWER_STEPS)
    viewer_s = time.perf_counter() - t0
    frames_readings("EnvReplayViewer", seen, VIEWER_STEPS + 1)
    ms = replay_s / frames.shape[0] * 1e3
    print(f"[path examine] examine.main({argv}) on the card: {wall:.2f} s with its construction "
          f"({MEMO.seconds['examine env']:.2f} s), its reset and {EXAMINE_STEPS} steps at B=1; "
          f"launches {launches}; replay_npz of the record through the raycaster: "
          f"{frames.shape[0]} frames {frames.shape[1:]} in {replay_s:.3f} s, {ms:.1f} ms a "
          f"frame; EnvReplayViewer.run({VIEWER_STEPS}): {seen.shape[0]} frames in "
          f"{viewer_s:.2f} s; no frame black")
    return dict(seconds=wall, batch=1, launches=launches, env_steps=EXAMINE_STEPS,
                construction_s=MEMO.seconds["examine env"], replay_ms_a_frame=ms,
                replay_frames=int(frames.shape[0]), viewer_s=viewer_s)


def create_holdout_path(tmp):
    """`scripts/create_holdout.py` on the card (`create_holdout.main` on the
    stand-in holdout's config, one settle step, the objects' settle at
    reset `OLDER_STABILIZE_STEPS` env steps), its env's construction shared
    through `MEMO` with the holdout env's; the saved npz holds the keys,
    shapes of the stand-in's saved initial state, its values finite:
    readings."""
    from robogym_torch.envs.rearrange import holdout
    from robogym_torch.scripts import create_holdout
    from robogym_torch.worlds import holdout_ball_like

    out_dir = os.path.join(tmp, "holdout")
    argv = [holdout_ball_like.CONFIG, f"out_dir={out_dir}", "kind=initial", "settle_steps=1",
            f"constants=@{{'stabilize_steps': {OLDER_STABILIZE_STEPS}}}"]

    def run():
        with constructing(holdout, "make_env", "create_holdout env"):
            create_holdout.main(argv)

    _, wall, launches = script_launches("create_holdout", run,
                                        ("spd_inverse", "cg_full", "hull_manifold", "hull_pair"))
    (path,) = [os.path.join(out_dir, f) for f in os.listdir(out_dir)]
    ref = os.path.join(holdout_ball_like.STATE_DIR, "initial_state_ball_like.npz")
    with np.load(path) as got, np.load(ref) as want:
        shapes = {k: got[k].shape for k in got.files}
        check(shapes == {k: want[k].shape for k in want.files},
              f"create_holdout: saved {shapes}, the reference {[(k, want[k].shape) for k in want]}")
        check(all(bool(np.isfinite(got[k]).all()) for k in got.files),
              "create_holdout: a saved value is not finite")
    print(f"[path create_holdout] create_holdout.main on the card: {wall:.2f} s with its "
          f"construction ({MEMO.seconds['create_holdout env']:.2f} s), its reset at B=1 and one "
          f"settle step; saved {os.path.basename(path)}: {shapes}; launches {launches}")
    return dict(seconds=wall, batch=1, launches=launches,
                construction_s=MEMO.seconds["create_holdout env"], saved=sorted(shapes))


def drive(name, run, calls):
    """Run a path with every launch count set to 0 just before it and read
    just after; check finiteness and the launch counts (`calls` substeps or
    calls of PER_CALL[name], or a function that gives them after the run).
    Returns (final state, seconds, launches)."""
    from robogym_torch import cuda

    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    d = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    calls = calls() if callable(calls) else calls
    for k in ("qpos", "qvel", "qacc"):
        check(bool(torch.isfinite(getattr(d, k)).all()), f"{name} path: non-finite {k}")
    for kernel, n in launches.items():
        want = PER_CALL[name].get(kernel, 0) * calls
        check(n == want, f"{name} path: {kernel} launched {n} times, want {want}")
    return d, wall, launches


def entry_launches(entry, entries, paths):
    """Launches of a kernels-line entry: for `k@w`, kernel k's launches on
    the path that steps world w, or, where that path does not run k, its
    launches on every path; for `k`, its launches on every path that no
    `k@...` entry stands for."""
    kernel, _, at = entry.partition("@")

    def at_paths(w):
        return {AT_PATH.get(w, w)} | {p for p, pw in ALSO_AT.items() if pw == w}

    if at:
        n = sum(paths[p]["launches"].get(kernel, 0) for p in at_paths(at) if p in paths)
        return n or sum(p["launches"].get(kernel, 0) for p in paths.values())
    claimed = set().union(*[at_paths(e.partition("@")[2]) for e in entries
                            if e.startswith(kernel + "@")])
    return sum(p["launches"].get(kernel, 0) for name, p in paths.items() if name not in claimed)


def profile_substeps(m, d, path):
    """torch.profiler over 3 substeps: kernel time by name, launches, and
    the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from robogym_torch.physics import step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            d = step.step(m, d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    head = (f"3 substeps at B={d.qpos.shape[0]} under the profiler: wall {wall_ms:.3f} ms, "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
            f"{n_kernels} kernel launches")
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(head + "\n" + table + "\n")
    print("[profile] " + head)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", help="write a profile of 3 substeps here")
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="also hold each CG and SPD phase's outputs to the kernels built from DIR "
                         "(another checkout's robogym_torch/csrc) and time both builds in turns")
    ap.add_argument("--settles", metavar="DIR", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.settles:
        if not torch.cuda.is_available():
            return 1
        sys.path.insert(0, REPO)
        return prefetch_settles(opts.settles)
    if opts.parent_csrc:
        PARENT.update(csrc=os.path.abspath(opts.parent_csrc),
                      build_dir=os.path.join(REPO, "build", "parent_kernels"))

    # 1. device
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from robogym_torch import cuda
    from robogym_torch.envs import core
    from robogym_torch.physics import cg_kernel, constraint, constraint_batched, factor_kernel, step
    from robogym_torch.physics.collision import boxbox_kernel, convex_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # 2. build, and meanwhile on the host 3. compile: every stand-in world
    # by the port's own compiler, each held to its committed snapshot, and
    # the rearrange env's worlds
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        compiling = pool.submit(lambda: (compile_phase(), compiled_rearrange_worlds()))
        log = cuda.build()
        print(f"[build] nvcc sm_90a, one process per source, {time.perf_counter() - t0:.1f} s")
        MEMO.start_prefetch()
        (cmodels, compile_s, compile_ruled), (rworlds, rworlds_s) = compiling.result()
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling entry" in line) or "spill" in line:
            print("  " + line.strip())
    print(f"[time] {time.perf_counter() - t_start:.1f} s since the start: build and compile")

    # 4. state
    B = BATCH
    world = worlds()
    state = {}
    for name, (m, arrays, kw) in world.items():
        t0 = time.perf_counter()
        state[name] = d = start_states(m, arrays, B, SEED, **kw)
        torch.cuda.synchronize()
        live = d.contact.active.sum(1) if d.contact.dist.shape[1] else torch.zeros(1)
        print(f"[state] {name}: B={B} settled {kw['settle']} substeps in "
              f"{time.perf_counter() - t0:.2f} s; live contacts per env: mean "
              f"{float(live.float().mean()):.2f}")
    for name in ("locked_like", "settle", "table", "dactyl"):
        check(bool(state[name].contact.active.any()), f"{name}: no live contact after settling")
    # every reset's seconds, since the one before it
    t_lap = [time.perf_counter()]

    def lap(label):
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[state time] {label}: {now - t_lap[0]:.2f} s", flush=True)
        t_lap[0] = now

    env, env_state = locked_env_reset(B, cmodels["dactyl_locked_like"])
    lap("locked env")
    kenv, kstate = locked_env_reset(B, cmodels["dactyl_locked_composed"], "composed locked env",
                                    "the world its builder composes from the stand-in asset tree")
    lap("composed locked env")
    wenv, wstate = wrapped_env_reset(env, B)
    lap("wrapped env")
    fenv, fstate, f_read = rubik_env_reset(B)
    lap("face env")
    wfenv, wfstate, wf_read = rubik_env_reset(B, bare=fenv)
    lap("wrapped face env")
    uenv, ustate, u_read = rubik_env_reset(B, "full")
    lap("full env")
    wuenv, wustate, wu_read = rubik_env_reset(B, "full", bare=uenv)
    lap("wrapped full env")
    renv, rstate, r_build, r_reset = rearrange_env_reset(B, worlds=rworlds)
    lap("rearrange env")
    jenv, jstate, j_build = reach_helper_reset(renv, rstate, REACH_HELPER_BATCH)
    lap("reach helper")
    tenv, tstate, t_build, t_reset = rearrange_env_reset(B, "blocks_train", BLOCKS_TRAIN_CONFIG,
                                                         "blocks_train env")
    cuboid_spread = blocks_train_readings(tenv, tstate)
    lap("blocks_train env")
    denv, dstate, d_build, d_reset = rearrange_env_reset(B, "dominos", DOMINOS_CONFIG,
                                                         "dominos env")
    lap("dominos env")
    qenv, qstate, q_build, q_reset = reach_env_reset(B)
    lap("reach env")
    qrenv, qchain, qrstate = randomized_reach_reset(qenv, B)
    lap("randomized reach env")
    venv, vstate = vision_env_reset(B)
    lap("dummy vision env")
    ienv, istate, i_read = real_image_env_reset(B)
    lap("real-image env")
    xenv, xstate, x_read = rearrange_vision_reset(B)
    lap("rearrange vision env")
    # the YCB env, built once; its own reset starts the ycb_env path, and a
    # copy under stabilize_goal (the same construction) resets for the
    # ycb_stabilized_env path, every env's first goal settled in the full
    # model
    t0 = time.perf_counter()
    with MEMO.construction("YCB env"):
        yenv = importlib.import_module("robogym_torch.envs.rearrange.ycb").make_env(
            *YCB_CONFIG, device="cuda", seed=SEED)
    y_build = time.perf_counter() - t0
    ystate, y_reset = rearrange_reset(yenv, B, "YCB env", y_build)
    ysenv = stabilized_copy(yenv)
    y_read = ycb_readings(yenv, ystate, "ycb_env")
    lap("YCB env")
    henv, hstate, h_build, h_reset = holdout_env_reset(B)
    lap("holdout env")
    # the mesh-family envs, each built by its make_env and reset; the
    # composer's system in B or, above B's shared memory, in F
    fam = {}
    for name in FAMILY:
        draws = {}
        env_k, state_k, built_k, reset_k = rearrange_env_reset(
            B, name, FAMILY_CONFIGS[name], f"{name} env", draws_out=draws)
        fam[name] = dict(env=env_k, state=state_k, build_s=built_k, reset_s=reset_k,
                         read=family_readings(name, env_k, state_k, draws))
        lap(f"{name} env")
    cenv, cstate = fam["composer"]["env"], fam["composer"]["state"]
    n8 = {k: v[:8] for k, v in cstate.model_fields.items()}
    efc = constraint.make_efc(core.apply_model_fields(cenv.model, n8),
                              core.data_map(lambda x: x[:8], cstate.physics))
    E_c, V_c = efc["J"].shape[1], cenv.model.const.nv
    route_c = "cg_full" if cg_kernel.fits(E_c, V_c, True) else "cg"
    PER_CALL["composer_env"][route_c] = PER_CALL["composer_env"].pop("cg_full")
    print(f"[composer] its system: E={E_c} rows, V={V_c}; smem an env "
          f"{cuda.cg_full_smem_bytes(E_c, V_c, True)} B, limit {cuda.max_smem_bytes()} B: "
          f"{'kernel B' if route_c == 'cg_full' else 'the size route (F)'} takes it")

    MEMO.stop_prefetch()
    print(f"[time] {time.perf_counter() - t_start:.1f} s since the start: build and state")

    # 5. one phase per kernel, on inputs captured from one substep or call
    # of a path; B and A also at the settle and hand worlds' shapes
    m, d = world["locked_like"][0], state["locked_like"]
    ci, iterations, nfacet = capture_core(m, d)
    res = {"spd_inverse": phase_spd("A spd_inverse", ci["qM"], REPS),
           "cg_full": phase_cg_full("B cg_full", ci, iterations, nfacet, REPS)}
    for name in ("hull_manifold", "hull_pair"):
        args = capture_call(convex_kernel, name, lambda: step.fwd_position(m, d))
        res[name] = phase_hull(name, args[:-1], args[-1], REPS)
        res[name + "_world"] = phase_world(name, args[:-1], args[-1], REPS)
    ms, ds = world["settle"][0], state["settle"]
    ci_s, its_s, nfacet_s = capture_core(ms, ds)
    check(ci_s["rows"]["Js"].shape[1] == 0, "settle world: scalar rows, want none")
    res["cg_full@settle"] = phase_cg_full("B cg_full@settle", ci_s, its_s, nfacet_s, REPS)
    res["boxbox"] = phase_boxbox(
        capture_call(boxbox_kernel, "boxbox", lambda: step.fwd_position(ms, ds)), REPS)
    mh, dh = world["hand"][0], state["hand"]
    res["spd_inverse@hand"] = phase_spd(
        "A spd_inverse@hand", capture_call(factor_kernel, "spd_inverse",
                                           lambda: step.step(mh, dh))[0], REPS)
    fa = capture_call(cg_kernel, "cg", lambda: step.step(mh, dh))
    res["cg"] = phase_cg_prebuilt(fa, REPS)
    res["cg_full_noeuler"] = phase_cg_noeuler(
        capture_call(constraint_batched, "solve_core", lambda: step.forward(m, d)), REPS)
    # the table world's two hull_manifold calls: its box-mesh group, then
    # its mesh-mesh group
    mt, dt = world["table"][0], state["table"]
    calls = capture_calls(convex_kernel, "hull_manifold", lambda: step.fwd_position(mt, dt))
    check([(c[0].shape[-1], c[3].shape[-1]) for c in calls] == [(8, 64), (64, 64)],
          f"table world: hull_manifold calls at {[tuple(c[0].shape) for c in calls]}")
    for at, (*targs, tDX) in zip(("table-box", "table"), calls):
        res["hull_manifold@" + at] = phase_hull("hull_manifold", targs, tDX, REPS,
                                                "C hull_manifold@" + at)
        res["hull_manifold_world@" + at] = phase_world("hull_manifold", targs, tDX, REPS,
                                                       "H hull_manifold_world@" + at)
    # A on the locked env's M (V=36, two rows a lane)
    me, de = env.model, env_state.physics
    ci_e, _, _ = capture_core(me, de)
    check(ci_e["qM"].shape[-1] == 36, f"locked env: V={ci_e['qM'].shape[-1]}, want 36")
    res["spd_inverse@dactyl"] = phase_spd("A spd_inverse@dactyl", ci_e["qM"], REPS)
    # B with each env's own timestep, from a step of the wrapped env, and
    # one timestep given once or per env
    ci_w, its_w, nfacet_w = capture_wrapped_core(wenv, wstate)
    dt_w = torch.as_tensor(ci_w["dt"])
    check(dt_w.shape == (B,) and bool((dt_w != dt_w[0]).any()),
          f"wrapped env: dt of shape {tuple(dt_w.shape)}, want ({B},), differing across envs")
    print(f"[B cg_full@dt] per-env timestep from a wrapped env step: {float(dt_w.min()):.6g} to "
          f"{float(dt_w.max()):.6g} s")
    res["cg_full@dt"] = phase_cg_full("B cg_full@dt", ci_w, its_w, nfacet_w, REPS)
    check_dt_stride(ci_e, its_w, nfacet_w)
    # the face env's kernels on the inputs of the last substep of one env
    # step from its reset state: A and B at its V=48 (the cube's 16 joint
    # equality rows among B's rows), C on the cubelets' box-mesh pairs, E
    # on the palm's box-box pairs
    fcap = capture_rubik_step(fenv, fstate)
    ci_f, its_f, nfacet_f = fcap["core"]
    V_f, E_f = ci_f["qM"].shape[-1], len(ci_f["kind"])
    eq_f = int((np.asarray(ci_f["kind"]) == constraint.EQ).sum())
    print(f"[face] kernel B's system: E={E_f} rows ({eq_f} equality rows), V={V_f}; "
          f"{'kernel B' if cg_kernel.fits(E_f, V_f, True) else 'the size route (F)'} takes it")
    check(V_f == fenv.model.const.nv == 48, f"face: V={V_f}, want 48")
    check(eq_f == 16, f"face: {eq_f} equality rows, want 16")
    check(cg_kernel.fits(E_f, V_f, True),
          f"face: E={E_f}, V={V_f} above kernel B's shared memory, and PER_CALL counts B")
    res["spd_inverse@face"] = phase_spd("A spd_inverse@face", ci_f["qM"], REPS)
    res["cg_full@face"] = phase_cg_full("B cg_full@face", ci_f, its_f, nfacet_f, REPS)
    *hargs_f, hDX_f = fcap["hull_manifold"]
    check(hDX_f == 6 and hargs_f[0].shape[-1] == 8,
          f"face: hull_manifold at V1={hargs_f[0].shape[-1]} DX={hDX_f}, want the boxes' 8, 6")
    res["hull_manifold@face"] = phase_hull("hull_manifold", hargs_f, hDX_f, REPS,
                                           "C hull_manifold@face")
    res["boxbox@face"] = phase_boxbox(fcap["boxbox"], REPS, "E boxbox@face")
    # the full env's kernels on the inputs of the last substep of one env
    # step from its reset state: A at V=96 (its 65-128-dof shared-memory
    # kernel), the solve (the pieces' 66 friction-loss rows among its
    # rows) in B or, where B does not take the system, F on the size
    # route, C on the pieces' box-mesh pairs, E on the palm's box-box pairs
    ucap = capture_rubik_step(uenv, ustate)
    ci_u, its_u, nfacet_u = ucap["core"]
    V_u, E_u = ci_u["qM"].shape[-1], len(ci_u["kind"])
    fr_u = int((np.asarray(ci_u["kind"]) == constraint.FRICTION).sum())
    fits_u = cg_kernel.fits(E_u, V_u, True)
    route_u = "cg_full" if fits_u else "cg"
    for path in ("full_env", "wrapped_full_env"):
        PER_CALL[path] = dict(PER_CALL["locked_env"])
        PER_CALL[path][route_u] = PER_CALL[path].pop("cg_full")
    print(f"[full] kernel B's system: E={E_u} rows ({fr_u} friction-loss rows), V={V_u}; smem "
          f"an env {cuda.cg_full_smem_bytes(E_u, V_u, True)} B, limit {cuda.max_smem_bytes()} B: "
          f"{'kernel B' if fits_u else 'the size route (F)'} takes it")
    check(V_u == uenv.model.const.nv == 96, f"full: V={V_u}, want 96")
    check(fr_u == 66, f"full: {fr_u} friction-loss rows, want the 66 piece hinges'")
    res["spd_inverse@full"] = phase_spd("A spd_inverse@full", ci_u["qM"], REPS)
    if fits_u:
        b_rows = b_rows_line("B cg_full@full", E_u, V_u)
        res["cg_full@full"] = phase_cg_full("B cg_full@full", ci_u, its_u, nfacet_u, REPS)
        res["cg_full@full"].update(b_rows)
    else:
        res["cg@full"] = phase_cg_routed("full", ci_u, its_u, nfacet_u, REPS)
        res["cg@full"].pop("routed_launches")
    *hargs_u, hDX_u = ucap["hull_manifold"]
    check(hDX_u == 6 and hargs_u[0].shape[-1] == 8,
          f"full: hull_manifold at V1={hargs_u[0].shape[-1]} DX={hDX_u}, want the boxes' 8, 6")
    res["hull_manifold@full"] = phase_hull("hull_manifold", hargs_u, hDX_u, REPS,
                                           "C hull_manifold@full")
    res["boxbox@full"] = phase_boxbox(ucap["boxbox"], REPS, "E boxbox@full")
    hop = solver_hop(uenv)
    # the reach env's kernels on the inputs of the last substep of its
    # physics from the reset state: A and B at its V=24, C on the palm's
    # box-mesh pairs with the fingers, D on the fingers' mesh-mesh pairs;
    # then one substep under effort control
    qcap = capture_reach_substep(qenv, qstate)
    ci_q, its_q, nfacet_q = qcap["core"]
    V_q, E_q = ci_q["qM"].shape[-1], len(ci_q["kind"])
    print(f"[reach] kernel B's system: E={E_q} rows, V={V_q}; "
          f"{'kernel B' if cg_kernel.fits(E_q, V_q, True) else 'the size route (F)'} takes it")
    check(V_q == qenv.model.const.nv == 24, f"reach: V={V_q}, want 24")
    check(cg_kernel.fits(E_q, V_q, True),
          f"reach: E={E_q}, V={V_q} above kernel B's shared memory, and PER_CALL counts B")
    res["spd_inverse@reach"] = phase_spd("A spd_inverse@reach", ci_q["qM"], REPS)
    res["cg_full@reach"] = phase_cg_full("B cg_full@reach", ci_q, its_q, nfacet_q, REPS)
    for name in ("hull_manifold", "hull_pair"):
        *hargs, hDX = qcap[name]
        res[name + "@reach"] = phase_hull(name, hargs, hDX, REPS,
                                          f"{HULL_LETTER[name]} {name}@reach")
    effort = effort_check(qenv, qstate)
    generators = goal_generator_checks(tenv, tstate, denv, B)
    # the size route: a system above kernel B's shared memory, through F,
    # and A at its V=96
    f_shape = tuple(fa[0].shape[1:])
    res["cg@wide"], wide_qM = phase_cg_wide(REPS, [((len(c["kind"]), c["qM"].shape[-1]), f_shape)
                                                   for c in (ci, ci_s, ci_e)], m.device)
    res["spd_inverse@wide"] = phase_spd_one_call("A spd_inverse@wide", wide_qM, REPS)
    res["spd_inverse@huge"] = phase_spd_one_call("A spd_inverse@huge",
                                                 dense_spd(B, HUGE_V, m.device), REPS // 5)
    res["spd_inverse@dev"] = phase_spd_one_call("A spd_inverse@dev",
                                                dense_spd(B, DEV_V, m.device), REPS // 5)
    # the Newton path's A on the last matrix of one substep (euler's M_imp)
    mn = m.replace(opt=dataclasses.replace(m.opt, solver="newton"))
    res["spd_inverse@newton"] = phase_spd(
        "A spd_inverse@newton", capture_call(factor_kernel, "spd_inverse",
                                             lambda: step.step(mn, d))[0], REPS)

    print(f"[time] {time.perf_counter() - t_start:.1f} s since the start: kernel phases")

    # 6. paths
    paths = {}

    def record(name, wall, counts, batch=B, **extra):
        paths[name] = dict(seconds=wall, batch=batch, launches=counts, **extra)

    dm, wall, counts = drive("locked_like", lambda: step.step_n(m, d, ENV_STEPS * SUBSTEPS),
                             ENV_STEPS * SUBSTEPS)
    sps = B * ENV_STEPS / wall
    record("locked_like", wall, counts, env_steps=ENV_STEPS, substeps=SUBSTEPS,
           env_steps_per_s=sps)
    print(f"[path locked_like] {ENV_STEPS} env steps x {SUBSTEPS} substeps at B={B}: {wall:.3f} s, "
          f"{sps:.1f} env-steps/s; launches {counts}; live contacts per env "
          f"{float(dm.contact.active.sum(1).float().mean()):.2f}")

    dn, wall, counts = drive("newton_step", lambda: step.step_n(mn, d, NEWTON_SUBSTEPS),
                             NEWTON_SUBSTEPS)
    live_n = float(dn.contact.active.sum(1).float().mean())
    record("newton_step", wall, counts, substeps=NEWTON_SUBSTEPS,
           substeps_per_s=NEWTON_SUBSTEPS / wall, live_contacts_per_env=live_n)
    print(f"[path newton_step] {NEWTON_SUBSTEPS} substeps of the locked-like world under the "
          f"Newton solve ({mn.opt.iterations} iterations, batched Cholesky) at B={B}: "
          f"{wall:.3f} s, {NEWTON_SUBSTEPS / wall:.1f} substeps/s; live contacts per env "
          f"{live_n:.2f}; launches {counts}")
    check(live_n > 0, "newton_step: no live contact")

    out, wall, counts = drive("settle", lambda: step.step_n(ms, ds, SETTLE_PATH_SUBSTEPS),
                              SETTLE_PATH_SUBSTEPS)
    record("settle", wall, counts, substeps=SETTLE_PATH_SUBSTEPS,
           substeps_per_s=SETTLE_PATH_SUBSTEPS / wall,
           settles_per_s=B * SETTLE_PATH_SUBSTEPS / SETTLE_SUBSTEPS / wall)
    print(f"[path settle] half a goal settle, {SETTLE_PATH_SUBSTEPS} substeps of 1 ms at B={B}: "
          f"{wall:.3f} s, {SETTLE_PATH_SUBSTEPS / wall:.1f} substeps/s, "
          f"{paths['settle']['settles_per_s']:.1f} settles/s of {SETTLE_SUBSTEPS}; "
          f"launches {counts}; live contacts per env "
          f"{float(out.contact.active.sum(1).float().mean()):.2f}")

    out, wall, counts = drive("hand", lambda: step.step_n(mh, dh, SUBSTEPS), SUBSTEPS)
    record("hand", wall, counts, env_steps=1, substeps=SUBSTEPS, env_steps_per_s=B / wall)
    print(f"[path hand] one env step, {SUBSTEPS} substeps at B={B}: {wall:.3f} s, "
          f"{B / wall:.1f} env-steps/s; launches {counts}")

    def forward_calls():
        for _ in range(FORWARD_CALLS):
            out = step.forward(m, d)
        return out

    out, wall, counts = drive("forward", forward_calls, FORWARD_CALLS)
    record("forward", wall, counts, calls=FORWARD_CALLS, calls_per_s=FORWARD_CALLS / wall)
    print(f"[path forward] {FORWARD_CALLS} forward() calls on the locked-like world at B={B}: "
          f"{wall:.3f} s, {FORWARD_CALLS / wall:.2f} calls/s; launches {counts}")

    out, wall, counts = drive("table_setting", lambda: step.step_n(mt, dt, SETTLE_PATH_SUBSTEPS),
                              SETTLE_PATH_SUBSTEPS)
    record("table_setting", wall, counts, substeps=SETTLE_PATH_SUBSTEPS,
           substeps_per_s=SETTLE_PATH_SUBSTEPS / wall,
           settles_per_s=B * SETTLE_PATH_SUBSTEPS / SETTLE_SUBSTEPS / wall)
    print(f"[path table_setting] half a goal settle of the table world, {SETTLE_PATH_SUBSTEPS} "
          f"substeps of 1 ms at B={B}: {wall:.3f} s, {SETTLE_PATH_SUBSTEPS / wall:.1f} substeps/s, "
          f"{paths['table_setting']['settles_per_s']:.1f} settles/s of {SETTLE_SUBSTEPS}; launches "
          f"{counts}; live contacts per env "
          f"{float(out.contact.active.sum(1).float().mean()):.2f}")

    def hull_world_step():
        dw = d
        for _ in range(SUBSTEPS):
            calls = {}
            with recording(convex_kernel, ("hull_pair", "hull_manifold"), calls):
                dw = step.step(m, dw)
            for name in ("hull_pair", "hull_manifold"):
                *a, DX = calls[name]
                outs = getattr(convex_kernel, name + "_world")(*to_world(a), DX)
                check(all(bool(torch.isfinite(o).all()) for o in outs),
                      f"hull_world path: non-finite {name}_world output")
        return dw

    out, wall, counts = drive("hull_world", hull_world_step, SUBSTEPS)
    record("hull_world", wall, counts, env_steps=1, substeps=SUBSTEPS)
    print(f"[path hull_world] one locked-like env step of {SUBSTEPS} substeps at B={B}, each "
          f"substep's hull winners through the world-vertex entry points: {wall:.3f} s; "
          f"launches {counts}")

    env_out = {}
    out, wall, counts = drive("locked_env", lambda: locked_env_steps(env, env_state, env_out),
                              ENV_STEPS * SUBSTEPS)
    sps = B * ENV_STEPS / wall
    record("locked_env", wall, counts, env_steps=ENV_STEPS, substeps=SUBSTEPS,
           env_steps_per_s=sps, reward_sum=env_out["reward_sum"], done=env_out["done"],
           on_palm=env_out["on_palm"])
    print(f"[path locked_env] {ENV_STEPS} LockedEnv.step calls x {SUBSTEPS} substeps at B={B} on "
          f"the port's compile of the dactyl-shaped world: {wall:.3f} s, {sps:.1f} env-steps/s "
          f"(the world equal to its snapshot bit for bit; on the snapshot in an earlier run, on "
          f"another host, {SNAPSHOT_RATES['locked_env']}); reward sum "
          f"{env_out['reward_sum']} (env, goal distance, success), episodes done "
          f"{env_out['done']}, on the palm {env_out['on_palm']:.4f}; launches {counts}")
    composed_out, store = {}, {}
    out, wall, counts = drive("composed_locked_env", captured(
        lambda run: capture_ends([(constraint_batched, "fused_step_core"),
                                  (convex_kernel, "hull_manifold"), (convex_kernel, "hull_pair"),
                                  (boxbox_kernel, "boxbox")], run),
        lambda: locked_env_steps(kenv, kstate, composed_out, "composed_locked_env"), store),
        ENV_STEPS * SUBSTEPS)
    caps = {"composed_locked_env": store["cap"]}
    csps = B * ENV_STEPS / wall
    record("composed_locked_env", wall, counts, env_steps=ENV_STEPS, substeps=SUBSTEPS,
           env_steps_per_s=csps, reward_sum=composed_out["reward_sum"],
           done=composed_out["done"], on_palm=composed_out["on_palm"])
    print(f"[path composed_locked_env] {ENV_STEPS} LockedEnv.step calls x {SUBSTEPS} substeps "
          f"at B={B} on the world cube_env.build_cube_world_xml composes from the stand-in "
          f"asset tree: {wall:.3f} s, {csps:.1f} env-steps/s (locked_env {sps:.1f} in this "
          f"run); reward sum {composed_out['reward_sum']} (env, goal distance, success), "
          f"episodes done {composed_out['done']}, on the palm {composed_out['on_palm']:.4f}; "
          f"launches {counts}")
    wrapped_out = {}
    out, wall, counts = drive("wrapped_env", lambda: wrapped_env_steps(wenv, wstate, wrapped_out),
                              ENV_STEPS * SUBSTEPS)
    wsps = B * ENV_STEPS / wall
    spread = check_field_spread(wenv, wrapped_out["state"].model_fields, wrapped_out["timesteps"])
    record("wrapped_env", wall, counts, env_steps=ENV_STEPS, substeps=SUBSTEPS,
           env_steps_per_s=wsps, reward_sum=wrapped_out["reward_sum"], done=wrapped_out["done"],
           on_palm=wrapped_out["on_palm"], field_spread=spread)
    print(f"[path wrapped_env] {ENV_STEPS} steps of the default dactyl wrapper stack x {SUBSTEPS} "
          f"substeps at B={B}, discrete actions ({N_ACTION_BINS} bins): {wall:.3f} s, "
          f"{wsps:.1f} env-steps/s (locked_env {sps:.1f} in this run, ratio {wsps / sps:.3f}); "
          f"reward sum {wrapped_out['reward_sum']} (env, goal distance, success), episodes done "
          f"{wrapped_out['done']}, on the palm {wrapped_out['on_palm']:.4f}; launches {counts}")
    rubik_out = {}
    for rubik, (benv, bstate, b_read, wenv_k, wstate_k, w_read, same) in (
            ("face", (fenv, fstate, f_read, wfenv, wfstate, wf_read, FACE_WRAPPED_SAME)),
            ("full", (uenv, ustate, u_read, wuenv, wustate, wu_read, FULL_WRAPPED_SAME))):
        steps, bare, wrapped = RUBIK[rubik]["steps"], f"{rubik}_env", f"wrapped_{rubik}_env"
        rubik_out[bare] = bout = {}
        out, wall, counts = drive(bare, lambda: rubik_env_steps(
            benv, bstate, bout, rearrange_actions(benv, B), bare, steps), steps * SUBSTEPS)
        record(bare, wall, counts, **rubik_path_readings(bare, benv, b_read, bout, wall, B, steps))
        print(f"[path {bare}] launches {counts}")
        rubik_out[wrapped] = wout = {}
        out, wall, counts = drive(wrapped, lambda: rubik_env_steps(
            wenv_k, wstate_k, wout, wrapped_actions(B, wenv_k.device), wrapped, steps),
            steps * SUBSTEPS)
        w_fields = wout["state"].model_fields
        extra = dict(field_spread=check_field_spread(wenv_k, w_fields, wout["timesteps"], same,
                                                     wrapped),
                     driver_damping_spread=damping_spread(wenv_k, w_fields, wrapped))
        if rubik == "full":
            extra["cube_size_spread"] = size_spread(wenv_k, w_fields, wrapped)
        record(wrapped, wall, counts, **extra,
               **rubik_path_readings(wrapped, wenv_k, w_read, wout, wall, B, steps))
        print(f"[path {wrapped}] discrete actions ({N_ACTION_BINS} bins), env-steps/s "
              f"{paths[wrapped]['env_steps_per_s']:.1f} ({bare} "
              f"{paths[bare]['env_steps_per_s']:.1f} in this run); launches {counts}")
    paths["full_env"]["solver_hop"] = hop
    paths["full_env"]["route"] = route_u
    # the paths of one step whose kernels' inputs the kernel phases below
    # take (`captured`: as `one_step` from the reset state, no second step)
    rearr_out, store = {}, {}
    out, wall, counts = drive("rearrange_env", captured(
        lambda run: capture_rearrange(renv, rstate, run=run),
        lambda: rearrange_env_steps(renv, rstate, rearr_out, REARRANGE_STEPS), store),
        REARRANGE_STEPS)
    caps["rearrange_env"] = store["cap"]
    rsps = B * REARRANGE_STEPS / wall
    record("rearrange_env", wall, counts, env_steps=REARRANGE_STEPS,
           substeps=renv.constants.mujoco_substeps, env_steps_per_s=rsps, build_s=r_build,
           reset_s=r_reset, compile_s=rworlds_s, reward_sum=rearr_out["reward_sum"],
           done=rearr_out["done"],
           off_table=rearr_out["off_table"], table_contact=rearr_out["table_contact"])
    print(f"[path rearrange_env] {REARRANGE_STEPS} BlocksRearrangeEnv.step calls at B={B} (each "
          f"{renv.constants.mujoco_substeps} main substeps, one solver fwd_position and "
          f"{renv.constants.mujoco_substeps} solver substeps) on the worlds compile_worlds "
          f"compiled, each equal to its snapshot bit for bit: {wall:.3f} s, {rsps:.1f} "
          f"env-steps/s (on the snapshots in an earlier run, on another host, "
          f"{SNAPSHOT_RATES['rearrange_env']}; built in {r_build:.2f} s, reset in {r_reset:.2f} "
          f"s); reward sum "
          f"{rearr_out['reward_sum']} (env, goal distance, success), episodes done "
          f"{rearr_out['done']}, env-steps with a block off the table {rearr_out['off_table']}, "
          f"gripper-table contact in {rearr_out['table_contact']:.4f} of envs a step; obs and "
          f"rewards finite; launches {counts} ({PER_CALL['rearrange_env']} an env step)")
    for name, env_, state_, steps, built, reset_s, extra in (
            ("blocks_train_env", tenv, tstate, BLOCKS_TRAIN_STEPS, t_build, t_reset,
             dict(cuboid_spread=cuboid_spread, goal_generators=generators)),
            ("dominos_env", denv, dstate, DOMINOS_STEPS, d_build, d_reset, {})):
        fam_out, store = {}, {}
        out, wall, counts = drive(name, captured(
            lambda run: capture_family_step(env_, state_, run=run),
            lambda: rearrange_env_steps(env_, state_, fam_out, steps, name), store), steps)
        caps[name] = store["cap"]
        if name == "blocks_train_env":
            extra = dict(extra, settle_budget=settle_budget_reading(env_, store["cap"][4]))
        fsps = B * steps / wall
        record(name, wall, counts, env_steps=steps, substeps=env_.constants.mujoco_substeps,
               env_steps_per_s=fsps, build_s=built, reset_s=reset_s,
               reward_sum=fam_out["reward_sum"], done=fam_out["done"],
               off_table=fam_out["off_table"], table_contact=fam_out["table_contact"], **extra)
        settle = (f", {env_.constants.stabilize_steps * env_.constants.mujoco_substeps} "
                  f"goal-settle substeps for every env"
                  if env_._settle_model is not None else "")
        print(f"[path {name}] {steps} {type(env_).__name__}.step calls at B={B} (each "
              f"{env_.constants.mujoco_substeps} main substeps, one solver fwd_position and "
              f"{env_.constants.mujoco_substeps} solver substeps{settle}): {wall:.3f} s, "
              f"{fsps:.1f} env-steps/s (rearrange_env {rsps:.1f} in this run; built in "
              f"{built:.2f} s, reset in {reset_s:.2f} s); reward sum {fam_out['reward_sum']} "
              f"(env, goal distance, success), episodes done {fam_out['done']}, env-steps with a "
              f"block off the table {fam_out['off_table']}; obs and rewards finite; launches "
              f"{counts} ({PER_CALL[name]} an env step)")
    reach_out = {}
    out, wall, counts = drive("reach_env", lambda: reach_env_steps(qenv, qstate, reach_out),
                              reach_calls(qenv, reach_out))
    record("reach_env", wall, counts, build_s=q_build, reset_s=q_reset, effort=effort,
           **reach_path_line("reach_env", qenv, reach_out, wall, B))
    print(f"[path reach_env] built in {q_build:.2f} s, reset in {q_reset:.2f} s; launches "
          f"{counts} ({PER_CALL['reach_env']} a substep, the goal sims' included)")
    rr_out = {}
    out, wall, counts = drive("randomized_reach_env",
                              lambda: reach_env_steps(qrenv, qrstate, rr_out),
                              reach_calls(qrenv, rr_out))
    spread = sim_field_spread(qrenv, qchain, rr_out["state"].model_fields)
    record("randomized_reach_env", wall, counts, field_spread=spread,
           **reach_path_line("randomized_reach_env", qrenv, rr_out, wall, B))
    print(f"[path randomized_reach_env] env-steps/s "
          f"{paths['randomized_reach_env']['env_steps_per_s']:.1f} (reach_env "
          f"{paths['reach_env']['env_steps_per_s']:.1f} in this run); launches {counts}")
    ppo_out = {}
    out, wall, counts = drive("ppo_train", lambda: ppo_train_steps(qenv, qstate, ppo_out),
                              lambda: (PPO_STEPS + PPO_ROLLOUT_STEPS + ppo_out["goal_sims"]
                                       * qenv.constants.goal_stabilize_steps) * SUBSTEPS)
    record("ppo_train", wall, counts, **ppo_readings(qenv, ppo_out, wall, B))
    print(f"[path ppo_train] launches {counts} ({PER_CALL['ppo_train']} a substep, the goal "
          f"sims' included)")
    helper_out = {}
    out, wall, counts = drive("reach_helper", lambda: reach_helper_run(jenv, jstate, helper_out),
                              lambda: int(helper_out["result"].steps.max()))
    record("reach_helper", wall, counts, **reach_helper_readings(
        jenv, helper_out, wall, REACH_HELPER_BATCH, j_build))
    print(f"[path reach_helper] launches {counts} ({PER_CALL['reach_helper']} an env step)")
    vis_out = {}
    out, wall, counts = drive("locked_dummy_vision_env",
                              lambda: vision_env_steps(venv, vstate, vis_out),
                              VISION_STEPS * SUBSTEPS)
    vsps = B * VISION_STEPS / wall
    record("locked_dummy_vision_env", wall, counts, env_steps=VISION_STEPS, substeps=SUBSTEPS,
           env_steps_per_s=vsps, resampled=vis_out["resampled"],
           goal_image_reads=vis_out["reads"])
    print(f"[path locked_dummy_vision_env] {VISION_STEPS} LockedEnv.step calls with dummy "
          f"vision x {SUBSTEPS} substeps at B={B}: {wall:.3f} s, {vsps:.1f} env-steps/s; goals "
          f"resampled a step {vis_out['resampled']}, goal images read for {vis_out['reads']} "
          f"envs; images zero, uint8; launches {counts}")
    img_out = {}
    torch.cuda.reset_peak_memory_stats()
    out, wall, counts = drive("locked_real_image_env",
                              lambda: real_image_steps(ienv, istate, img_out, REAL_IMAGE_STEPS),
                              REAL_IMAGE_STEPS * SUBSTEPS)
    record("locked_real_image_env", wall, counts, **vision_path_line(
        "locked_real_image_env", wall, img_out, REAL_IMAGE_STEPS, B, i_read,
        advanced=img_out["advanced"]))
    x_out = {}
    torch.cuda.reset_peak_memory_stats()
    with timed_renders(x_out):
        out, wall, counts = drive("rearrange_vision_env", lambda: rearrange_env_steps(
            xenv, xstate, x_out, REARRANGE_VISION_STEPS, "rearrange_vision_env"),
            REARRANGE_VISION_STEPS)
    record("rearrange_vision_env", wall, counts, **vision_path_line(
        "rearrange_vision_env", wall, x_out, REARRANGE_VISION_STEPS, B, x_read,
        reward_sum=x_out["reward_sum"], done=x_out["done"], off_table=x_out["off_table"]))
    ycb_out, ycb_live, store = {}, [], {}
    ygroups = mesh_groups(yenv.model)
    out, wall, counts = drive("ycb_env", captured(
        lambda run: capture_rearrange(yenv, ystate, ("hull_manifold", "hull_pair"), run),
        lambda: rearrange_env_steps(
            yenv, ystate, ycb_out, YCB_STEPS, "ycb_env",
            per_step=lambda st: ycb_live.append(live_pairs(yenv.model, st.physics, ygroups))),
        store), YCB_STEPS)
    caps["ycb_env"] = store["cap"]
    ysps = B * YCB_STEPS / wall
    live_y = {f"{k[0]} {k[1]}-{k[2]}": [int(step[k]) for step in ycb_live] for k in ygroups}
    record("ycb_env", wall, counts, env_steps=YCB_STEPS, substeps=yenv.constants.mujoco_substeps,
           env_steps_per_s=ysps, build_s=y_build, reset_s=y_reset,
           reward_sum=ycb_out["reward_sum"], done=ycb_out["done"],
           off_table=ycb_out["off_table"], table_contact=ycb_out["table_contact"],
           live_contacts=live_y, **y_read)
    print(f"[path ycb_env] {YCB_STEPS} YcbRearrangeEnv.step calls at B={B}: {wall:.3f} s, "
          f"{ysps:.1f} env-steps/s (rearrange_env {rsps:.1f} in this run; built in "
          f"{y_build:.2f} s, reset in {y_reset:.2f} s); live contacts over the batch a step "
          f"(mesh-mesh of free bodies, box-mesh) {live_y}; reward sum {ycb_out['reward_sum']}, "
          f"episodes done {ycb_out['done']}, env-steps with an object off the table "
          f"{ycb_out['off_table']}; obs and rewards finite; launches {counts} "
          f"({PER_CALL['ycb_env']} an env step)")
    check(all(sum(v) > 0 for v in live_y.values()), f"ycb_env: a mesh group never live {live_y}")
    ys_out = {}
    out, wall, counts = drive("ycb_stabilized_env",
                              lambda: ycb_stabilized_steps(ysenv, ystate, ys_out), 1)
    record("ycb_stabilized_env", wall, counts, env_steps=1, settle_s=ys_out["settle_s"],
           settled_envs=ys_out["settled_envs"])
    print(f"[path ycb_stabilized_env] one step at B={B} under stabilize_goal from the YCB env's "
          f"reset state (its construction copied): {wall:.3f} s; the goal settle "
          f"({GOAL_SETTLE_SUBSTEPS} main substeps) on exactly the {ys_out['settled_envs']} "
          f"resampling "
          f"envs in {ys_out['settle_s']:.3f} s; the others' goals kept; launches {counts} "
          f"({PER_CALL['ycb_stabilized_env']} a step with one settle)")
    hold_out, hold_live, store = {}, [], {}
    hgroups = round_groups(henv.model)
    out, wall, counts = drive("holdout_env", captured(
        lambda run: capture_rearrange(henv, hstate, ("hull_manifold", "hull_pair"), run),
        lambda: rearrange_env_steps(
            henv, hstate, hold_out, HOLDOUT_STEPS, "holdout_env",
            per_step=lambda st: hold_live.append(live_pairs(henv.model, st.physics, hgroups))),
        store), HOLDOUT_STEPS)
    caps["holdout_env"] = store["cap"]
    hsps = B * HOLDOUT_STEPS / wall
    live_h = {f"{k[0]} {k[1]}-{k[2]}": [int(step[k]) for step in hold_live] for k in hgroups}
    record("holdout_env", wall, counts, env_steps=HOLDOUT_STEPS,
           substeps=henv.constants.mujoco_substeps, env_steps_per_s=hsps, build_s=h_build,
           reset_s=h_reset, reward_sum=hold_out["reward_sum"], done=hold_out["done"],
           off_table=hold_out["off_table"], round_group_live=live_h)
    print(f"[path holdout_env] {HOLDOUT_STEPS} HoldoutRearrangeEnv.step calls at B={B}: "
          f"{wall:.3f} s, {hsps:.1f} env-steps/s (built in {h_build:.2f} s, reset in "
          f"{h_reset:.2f} s); live pairs over the batch a step of the round-geom groups "
          f"(sphere=2, cylinder=5, box=6, mesh=7) {live_h}; reward sum "
          f"{hold_out['reward_sum']}, episodes done {hold_out['done']}, env-steps with an object "
          f"off the table {hold_out['off_table']}; launches {counts} "
          f"({PER_CALL['holdout_env']} an env step)")
    check(all(sum(v) > 0 for v in live_h.values()),
          f"holdout_env: a round-geom group had no live pair over the steps {live_h}")
    # the scripts on the card, their constructions shared with the locked
    # and holdout envs'
    with tempfile.TemporaryDirectory() as tmp:
        paths["examine"] = examine_path(tmp)
        paths["create_holdout"] = create_holdout_path(tmp)
    for name in FAMILY:
        f = fam[name]
        env_k, out_k, live_k, store = f["env"], {}, [], {}
        out, wall, counts = drive(name + "_env", captured(
            lambda run, e=env_k, st=f["state"]: capture_rearrange(
                e, st, ("hull_manifold", "hull_pair"), run),
            lambda e=env_k, st=f["state"], o=out_k, lv=live_k, n=name: family_path(n, e, st, o, lv),
            store), FAMILY_STEPS)
        caps[name + "_env"] = store["cap"]
        fsps = B * FAMILY_STEPS / wall
        live = {k: [int(v[k]) for v in live_k] for k in live_k[0]}
        record(name + "_env", wall, counts, env_steps=FAMILY_STEPS,
               substeps=env_k.constants.mujoco_substeps, env_steps_per_s=fsps,
               build_s=f["build_s"], reset_s=f["reset_s"], reward_sum=out_k["reward_sum"],
               done=out_k["done"], off_table=out_k["off_table"], live_contacts=live, **f["read"])
        print(f"[path {name}_env] {FAMILY_STEPS} {type(env_k).__name__}.step calls at B={B}: "
              f"{wall:.3f} s, {fsps:.1f} env-steps/s (ycb_env {ysps:.1f} in this run; built in "
              f"{f['build_s']:.2f} s, reset in {f['reset_s']:.2f} s); live contacts over the "
              f"batch a step {live}; reward sum {out_k['reward_sum']}, episodes done "
              f"{out_k['done']}, env-steps with an object off the table {out_k['off_table']}; "
              f"launches {counts} ({PER_CALL[name + '_env']} an env step)")
        # objects that rest apart touch only the table (its box-mesh group),
        # the table setting's only its top plane and each other (its box-mesh
        # group is the table against the links)
        groups = [v for k, v in live.items() if k.startswith(("box_convex", "convex"))]
        check(all(sum(step) > 0 for step in zip(*groups)),
              f"{name}_env: no live mesh contact at a step {live}")
        if name == "composer":
            check(all(v > 0 for v in live["sub-geom"]), f"composer_env: no live sub-geom {live}")
        check(out_k["off_table"] == 0, f"{name}_env: an object off the table")
        f.update(out=out_k)

    # the composed locked env's kernels on the inputs of the last substep of
    # its path: A and B at its V=36, C on the palm's and the cube's box-mesh
    # pairs with the fingers, D on the fingers' mesh-mesh pairs, E on the
    # palm's box-box pair with the cube
    ccap = caps["composed_locked_env"]
    kind_k2, its_k2, nfacet_k2, *args_k2 = ccap["fused_step_core"][1]
    ci_k2 = constraint_batched.core_inputs(kind_k2, nfacet_k2, *args_k2)
    V_k2, E_k2 = ci_k2["qM"].shape[-1], len(ci_k2["kind"])
    print(f"[composed] kernel B's system: E={E_k2} rows, V={V_k2}; "
          f"{'kernel B' if cg_kernel.fits(E_k2, V_k2, True) else 'the size route (F)'} takes it")
    check(V_k2 == kenv.model.const.nv == 36, f"composed: V={V_k2}, want 36")
    check(cg_kernel.fits(E_k2, V_k2, True),
          f"composed: E={E_k2}, V={V_k2} above kernel B's shared memory, and PER_CALL counts B")
    res["spd_inverse@composed"] = phase_spd("A spd_inverse@composed", ci_k2["qM"], REPS)
    res["cg_full@composed"] = phase_cg_full("B cg_full@composed", ci_k2, its_k2, nfacet_k2, REPS)
    for name in ("hull_manifold", "hull_pair"):
        *hargs, hDX = ccap[name][1]
        res[name + "@composed"] = phase_hull(name, hargs, hDX, REPS,
                                             f"{HULL_LETTER[name]} {name}@composed")
    res["boxbox@composed"] = phase_boxbox(ccap["boxbox"][1], REPS, "E boxbox@composed")
    # the rearrange env's kernels on the inputs of the rearrange_env path's step
    # from its reset state: A at the main sim's and the solver sim's V, B on the
    # solver sim's system (its weld, connect and joint rows) and on the main
    # sim's, C, D and E on the main sim's last substep
    rcap = caps["rearrange_env"]
    for at, model in (("rearrange", renv.model), ("solver", renv.solver_model)):
        ci_r, its_r, nfacet_r = rcap["main" if at == "rearrange" else "solver"]
        V_r, E_r = ci_r["qM"].shape[-1], len(ci_r["kind"])
        eq = int((np.asarray(ci_r["kind"]) == constraint.EQ).sum())
        print(f"[{at}] kernel B's system: E={E_r} rows ({eq} equality rows), V={V_r}; "
              f"{'kernel B' if cg_kernel.fits(E_r, V_r, True) else 'the size route (F)'} takes it")
        check(V_r == model.const.nv, f"{at}: V={V_r}, want {model.const.nv}")
        check(cg_kernel.fits(E_r, V_r, True),
              f"{at}: E={E_r}, V={V_r} above kernel B's shared memory, and PER_CALL counts B")
        check(eq == {"rearrange": 7, "solver": 13}[at], f"{at}: {eq} equality rows")
        res["spd_inverse@" + at] = phase_spd("A spd_inverse@" + at, ci_r["qM"], REPS)
        res["cg_full@" + at] = phase_cg_full("B cg_full@" + at, ci_r, its_r, nfacet_r, REPS)
    for name in ("hull_manifold", "hull_pair"):
        *hargs, hDX = rcap[name]
        res[name + "@rearrange"] = phase_hull(name, hargs, hDX, REPS,
                                              f"{HULL_LETTER[name]} {name}@rearrange")
    res["boxbox@rearrange"] = phase_boxbox(rcap["boxbox"], REPS, "E boxbox@rearrange")
    # the solver sim's C and D: its fwd_position's calls, the first of a step
    for name in ("hull_manifold", "hull_pair"):
        *hargs, hDX = rcap[name + "@first"]
        print(f"[solver] {name}: K={hargs[0].shape[1]}, V1={hargs[0].shape[-1]}, "
              f"V2={hargs[3].shape[-1]}, DX={hDX}")
        res[name + "@solver"] = phase_hull(name, hargs, hDX, REPS,
                                           f"{HULL_LETTER[name]} {name}@solver")
    # the YCB env's and the holdout's kernels on the inputs of the main
    # sim's last substep of their paths' step from their reset states: A and B
    # at their V, C on the YCB env's mesh-mesh group (each env's own hulls:
    # its verts differ across envs) and on the holdout's box-mesh group, D
    # on the fingers (the YCB env swaps no link's hull: the same in every
    # env) and on the holdout's platform against the links
    for at, env_k in (("ycb", yenv), ("holdout", henv)):
        cap = caps[at + "_env"]
        ci_k, its_k, nfacet_k = cap["main"]
        V_k, E_k = ci_k["qM"].shape[-1], len(ci_k["kind"])
        print(f"[{at}] kernel B's system: E={E_k} rows, V={V_k}; "
              f"{'kernel B' if cg_kernel.fits(E_k, V_k, True) else 'the size route (F)'} takes it")
        check(V_k == env_k.model.const.nv, f"{at}: V={V_k}, want {env_k.model.const.nv}")
        check(cg_kernel.fits(E_k, V_k, True),
              f"{at}: E={E_k}, V={V_k} above kernel B's shared memory, and PER_CALL counts B")
        res["spd_inverse@" + at] = phase_spd("A spd_inverse@" + at, ci_k["qM"], REPS)
        res["cg_full@" + at] = phase_cg_full("B cg_full@" + at, ci_k, its_k, nfacet_k, REPS)
        for name in ("hull_manifold", "hull_pair"):
            *hargs, hDX = cap[name]
            per_env = [bool((v != v[:1]).any()) for v in (hargs[0], hargs[3])]
            print(f"[{at}] {name}: K={hargs[0].shape[1]}, V1={hargs[0].shape[-1]}, "
                  f"V2={hargs[3].shape[-1]}, DX={hDX}; local verts differ across envs "
                  f"(side 1, side 2): {per_env}")
            if at == "ycb" and name == "hull_manifold":
                check(all(per_env) and hargs[0].shape[-1] == 64,
                      "ycb: the mesh-mesh hull_manifold call's verts are not each env's own")
            res[f"{name}@{at}"] = phase_hull(name, hargs, hDX, REPS,
                                             f"{HULL_LETTER[name]} {name}@{at}")
        if at == "ycb":
            res["hull_manifold@ycb-box"] = phase_box_mesh(at, cap)
    # blocks_train's goal settle (the objects-only settle world, nv=48) on the
    # inputs of its last substep in its path's step from the reset state; the
    # dominos world's box-box pairs on its main sim's last substep
    ci_t, its_t, nfacet_t, bb_t, _ = caps["blocks_train_env"]
    V_t, E_t = ci_t["qM"].shape[-1], len(ci_t["kind"])
    print(f"[settle8] kernel B's system: E={E_t} rows, V={V_t}; "
          f"{'kernel B' if cg_kernel.fits(E_t, V_t, True) else 'the size route (F)'} takes it")
    check(V_t == tenv._settle_model.const.nv == 48, f"settle8: V={V_t}, want 48")
    check(cg_kernel.fits(E_t, V_t, True),
          f"settle8: E={E_t}, V={V_t} above kernel B's shared memory, and PER_CALL counts B")
    res["spd_inverse@settle8"] = phase_spd("A spd_inverse@settle8", ci_t["qM"], REPS)
    res["cg_full@settle8"] = phase_cg_full("B cg_full@settle8", ci_t, its_t, nfacet_t, REPS)
    res["boxbox@settle8"] = phase_boxbox(bb_t, REPS, "E boxbox@settle8")
    res["boxbox@dominos"] = phase_boxbox(caps["dominos_env"][3], REPS, "E boxbox@dominos")
    # the mesh-family worlds' kernels on the inputs of the main sim's last
    # substep of their paths' step from their reset states (as the YCB env's):
    # A and B at their V and E, C on the mesh-mesh group of free bodies
    # (each env's own hulls; the composer's sub-geoms at each env's own
    # offsets)
    for name in FAMILY:
        at, env_k = FAMILY_AT[name], fam[name]["env"]
        cap = caps[name + "_env"]
        ci_k, its_k, nfacet_k = cap["main"]
        V_k, E_k = ci_k["qM"].shape[-1], len(ci_k["kind"])
        fits_k = cg_kernel.fits(E_k, V_k, True)
        print(f"[{at}] kernel B's system: E={E_k} rows, V={V_k}; "
              f"{'kernel B' if fits_k else 'the size route (F)'} takes it")
        check(V_k == env_k.model.const.nv, f"{at}: V={V_k}, want {env_k.model.const.nv}")
        check(fits_k == ("cg_full" in PER_CALL[name + "_env"]),
              f"{at}: E={E_k}, V={V_k} not on the route PER_CALL counts")
        res["spd_inverse@" + at] = phase_spd("A spd_inverse@" + at, ci_k["qM"], REPS)
        if fits_k:
            b_rows = b_rows_line("B cg_full@" + at, E_k, V_k)
            res["cg_full@" + at] = phase_cg_full("B cg_full@" + at, ci_k, its_k, nfacet_k, REPS)
            res["cg_full@" + at].update(b_rows)
        else:
            res["cg@" + at] = phase_cg_routed(at, ci_k, its_k, nfacet_k, REPS)
            res["cg@" + at].pop("routed_launches")
        *hargs, hDX = cap["hull_manifold"]
        per_env = [bool((v != v[:1]).any()) for v in (hargs[0], hargs[3])]
        print(f"[{at}] hull_manifold: K={hargs[0].shape[1]}, V1={hargs[0].shape[-1]}, "
              f"V2={hargs[3].shape[-1]}, DX={hDX}; local verts differ across envs (side 1, "
              f"side 2): {per_env}")
        check(hDX == 0 and hargs[0].shape[-1] == 64,
              f"{at}: the last hull_manifold call is not the mesh-mesh group")
        res["hull_manifold@" + at] = phase_hull("hull_manifold", hargs, hDX, REPS,
                                                "C hull_manifold@" + at)
        res[f"hull_manifold@{at}-box"] = phase_box_mesh(at, cap)
    launches = {entry: r["launches"] if "launches" in r else entry_launches(entry, res, paths)
                for entry, r in res.items()}
    for k in KERNELS:
        check(sum(p["launches"].get(k, 0) for p in paths.values()) > 0,
              f"{k} was launched on no path")
    for entry, n in launches.items():
        check(n > 0, f"{entry}: no launch on the paths it stands for")

    print(f"[time] {time.perf_counter() - t_start:.1f} s since the start: paths")

    # 7. whole-step agreement at B=64: one substep through the kernels
    # against one through the plain versions; qpos to 1e-4 abs, qvel to
    # 1e-3 of its largest value (the CG's float32 noise, phase B)
    for name, (mw, arrays, kw) in world.items():
        dw = core.data_map(lambda x: x[:64], state[name])
        got = step.step(mw, dw)
        with plain_versions():
            want = step.step(mw, dw)
        torch.cuda.synchronize()
        for k in ("qpos", "qvel"):
            g, w = getattr(got, k), getattr(want, k)
            e = float((g - w).abs().max())
            tol = 1e-4 if k == "qpos" else 1e-3 * float(w.abs().max())
            print(f"[whole step] {name}, B=64 one substep, kernels vs plain versions: {k} max "
                  f"abs err {e:.3g} (tol {tol:.3g})")
            check(bool(torch.isfinite(g).all()) and e <= tol,
                  f"whole step {name}: {k} differs by {e:.3g} > {tol:.3g}")

    wrapped_agreement(wenv, wrapped_out["state"])
    rearrange_agreement(renv, rearr_out["state"])
    for label, env_k in (("face_env", fenv), ("wrapped_face_env", wfenv.env),
                         ("full_env", uenv), ("wrapped_full_env", wuenv.env)):
        nudged_agreement(label, env_k.model, rubik_out[label]["state"],
                         env_k.cube.cube_pos_qpos)
    reach_agreement(qenv, reach_out["state"])
    wrapped_agreement(None, rr_out["state"], model=qrenv.model, label="randomized_reach_env")
    rearrange_agreement(yenv, ycb_out["state"], label="ycb", path="ycb_env", solver=False)
    rearrange_agreement(henv, hold_out["state"], label="holdout", path="holdout_env",
                        solver=False)
    cube = int(mn.const.jnt_qposadr[mn.const.names["joint"]["cube_j"]])
    nudged_agreement("newton", mn, dn, range(cube, cube + 3), substeps=1)
    for name in FAMILY:
        env_k = fam[name]["env"]
        nudged_agreement(name, env_k.model, fam[name]["out"]["state"], object_cols(env_k))

    print(f"[time] {time.perf_counter() - t_start:.1f} s since the start: agreement")
    if opts.profile:
        profile_substeps(m, dm, opts.profile)

    # 8. summary
    kernels = []
    for entry, r in res.items():
        k = KERNELS[entry.partition("@")[0]]
        kernels.append(dict(
            name=entry, route="cuda", source="robogym_torch/csrc/" + k["source"],
            replaces=k["replaces"], launches=launches[entry], max_abs_err=r["max_abs_err"], max_err=r["max_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"paths": paths, "compile": {"seconds": compile_s, "held_by_meaning":
                                                  compile_ruled}, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        MEMO.close()
