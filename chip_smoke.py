#!/usr/bin/env python3
"""Smoke run of hairpt_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that
the full-width furball forward render runs through them, with the tiled
and with the swept traversal, with rough plastic and with the Marschner
hair BSDF, its gradient paths and inverse rendering with them, the
scene-XML command line, triangle meshes (the teapot stand-in) through the
packed BVH walk, instanced, bitmap-textured and normal-mapped meshes
(the instanced stand-in) through the two-level walk, the per-ray and the
blocked walks (traversal 'perray' and 'blocked'), and motion blur (the
motion stand-in: an animated camera, meshes and instances under an open
shutter), the tiled query's options (subcull, short-ray-first,
two-round), area and delta lights (the lit stand-in), rendering and the
inverse step across GPUs (parallel/mesh.py: NCCL at world size 1, two
gloo ranks on the one card), the surface BSDFs and wrapper materials
under a thin lens (the materials stand-in), the other sensors, and
participating media and subsurface scattering (the volpath integrator
through kernel J, Woodcock tracking; the hk BSDF; the dipole and single
scattering), the light tracers and photon maps (ptracer, bdpt, vpl,
ppm, sppm and the beam radiance estimate in fog, through kernel K, the
hash-grid photon query), and the other integrators (direct, ao, field,
adaptive, multichannel, irrcache through kernel L, the irradiance-cache
interpolation, pssmlt, erpt and spectral), path-space MLT with the
specular manifold walk and the motion-vector integrator, the irawan
woven-cloth BSDF and the command line's banded render, statistics,
profiler trace, image tools and COLLADA import, and the image codecs
(JPEG written and read on the card, no imaging library), the film's
annotations and banner, and make_li_fn's ablate knobs.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one line with its elapsed seconds):
  0. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1. build the eleven CUDA libraries (nvcc, sm_90a: tiled.cu with
     kernels A and B, octets.cu with C and D, phaseb.cu with E,
     swept_cull.cu with the swept phase A, packed.cu with F, instanced.cu
     with G, perray.cu with H, blocked.cu with I, woodcock.cu with J,
     photons.cu with K, irrcache.cu with L) and the BVH builder (g++), all
     twelve in parallel;
  2. build the full-width furball scene (84,000 fibers x 12 segments,
     K = 128), take a real camera wave and a first-bounce wave (uniformly
     random directions at the camera hit points, Morton-sorted as the
     bounce queries are), and
       a. hold kernel A (phase-A cull, with and without its octet output)
          and kernels B, C and D (dense, octet and stream phase B, closest
          and any hit; C and D on the routing of A's octet output, q =
          2048, stream_qo 512) against their plain PyTorch versions on
          EVERY tile of both waves, with the share of (tile, cluster)
          pairs that pass A's tile test (group_cull_plain) and of (ray,
          slot) or (ray, entry) pairs that pass the box cull of B, C and
          D; time A on both whole waves beside its bounds, and B, C and D
          beside the bound of the closest-hit function they share (the
          plain side's pairs and blocks) and beside each one's own work;
       b. run both whole waves through tiled_closest_hit / tiled_any_hit
          with octets=True and with streams=True (q = 2048, the JAX
          default stream_qo = 512) and compare each with
          the dense query; the launches of A's octet variant, C and D are
          counted over these queries;
       c. hold the swept phase-A kernel against _phase_a_dense on EVERY
          ray of the camera wave, the first-bounce wave (in lane order,
          as the swept traversal takes it) and the dead lanes at the
          camera hits (slots, cnt and n_hit equal; on the camera wave
          also with a p_max whose key lists leave shared memory), and
          kernel E (the swept traversal's chunk test) against its plain
          version on a contiguous quarter of the live chunks those slots
          route and a tail of dead chunks (t and pid bit for bit); time
          both on the camera and bounce waves beside their bounds, with
          the shares of padding lanes, dead lanes and entered sub-boxes
          that set kernel E's work;
     and time every kernel and its plain version at the camera wave's
     shapes;
  2d. kernels A and B against their plain versions, with 2a's rules, on
     EVERY tile of the camera and first-bounce waves of two more hair
     scenes at quality 14: the straight-hair curtain (11,200 fibers x 24
     segments, radius 0.00567) and the four hair-curl clumps (12,320
     fibers x 48 segments, radius 0.000444), 1024^2;
  3. a small furball rendered on the card and with the plain versions on
     the CPU, with the tiled and with the swept traversal: the image means
     must agree, and the swept render on the card must go through both
     swept kernels (the phase-A kernel's lowest-ids branch);
  4. the full-width render (1024^2, depth 65, true Sobol', q = 2048,
     shadow-ray RR 0.01, rough plastic, baked sunsky) through SceneBuilder
     -> build -> render: one warm-up wave and two timed 1-spp waves, with
     kernels A and B's launch counts taken over the timed waves;
  3b. gradients of the small furball's mean radiance with respect to
     diffuse, specular, alpha and eta (the differentiable mode, depth 8)
     on the card and with the plain versions on the CPU: the loss and
     every gradient component must agree; then path-replay backprop
     against the differentiable mode on the card at depths 3 and 5
     (rr_depth 999, nee_rr 0);
  3c. the small furball with each hair BSDF (Kajiya-Kay, Marschner
     faithful and corrected, MarschnerDielectric) on the card and with the
     plain versions on the CPU: image means within 2%; the sigma_a and
     beta_r gradients (through the azimuthal tables) card against CPU at
     depth 8 for both Marschner modes, 3b's bounds; PRB against the
     differentiable mode on the card for MARSCHNER_PURE at depths 3 and 5;
  5. the same render with traversal='swept' (p_max 24, chunks of 64): one
     warm-up wave and one or two timed waves, the launches of the swept
     phase-A kernel and kernel E counted over them (no plain version on
     CUDA tensors, no tiled kernel);
  6. bench.py's backward phase on the phase-4 scene at depth 16: the
     gradient of mean(nan_to_num(radiance)) over the 1024^2 film (lanes in
     pixel order) with respect to a 3-vector diffuse broadcast over the
     material table, one warm-up step and two timed fwd+bwd steps; kernels
     A and B must be launched as often over the timed steps as over the
     same steps' forward passes run alone (the backward traces no query);
  7. path-replay backprop at depth 65 (the same scene with nee_rr 0): one
     warm-up step and one timed step; its red diffuse gradient must have
     phase 6's sign;
  8. phase 4's render with the Marschner furball (MARSCHNER_PURE, sigma_a
     0.5, beta_R 0.1, eta 1.55): one warm-up and two timed waves, A and
     B's launches per wave, a finite positive image mean;
  9. phase 6 on that scene: the gradient with respect to sigma_a [1, 3]
     and beta_r [1] (the hair tables recomputed from them), depth 16, one
     warm-up and two timed steps, the launches equal to the forward
     passes' alone, every gradient finite, the peak memory;
  10. (run while 16b's gloo ranks work) the inverse-rendering twin
     (hairpt_torch.tools.inverse_furball) at its defaults: res 256, 6,000 fibers, spp 2, depth 3, 24 steps,
     antithetic, the cross loss; the loss's mean over the last third of
     the steps must be below step 1's (step 0 shares a sample index with
     the target).
  11. the scene-XML entry point: the stand-in scene XMLs of
     hairpt_torch.scene.scene_xmls (the reference's furball, straight-hair
     (Marschner and Kajiya-Kay), hair-curl and curly-hair XMLs are not in
     the repository) written into a temporary directory; the CLI run as a
     user runs it, `python3 -m hairpt_torch.cli render furball/scene.xml
     -o furball.png --hair-quality 14 --spp 2` (1024^2, depth 65, on the
     card): exit 0 and four outputs, the .npy finite with a positive
     mean; load_scene of the same XML against the same scene through
     SceneBuilder: the config and every tensor equal, A and B launched
     on its 1-spp wave as often as on the builder's, and the two images
     torch.equal with the film's sums in a fixed order; the other four
     XMLs at half scale, one wave each: finite, non-black, A and B
     launched.
  12. triangle meshes through kernel F (csrc/packed.cu, the packed BVH
     walk, one thread per ray):
       a. F (triangle leaf) against its plain walk on EVERY ray of the
          teapot stand-in's camera and first-bounce waves (1280 x 720) and
          of a 1025^2 heightfield's (the JAX loader's ripples, 2,097,152
          triangles), closest and any hit, t and pid bit for bit; timed
          beside the plain walk and the bound (the inputs read once, the
          operations of the walk's counted visits);
       b. (run in phase 2, on its waves) F's hair leaf on the full
          furball's camera and first-bounce waves: against its plain walk
          bit for bit on a contiguous quarter of each wave's rays, and
          against the tiled query, whose cylinder arithmetic differs
          (pid >= 99.9%, hit flags differing on at most 1e-5 of the
          rays, t within T_RTOL on >= 99.9% of the same-pid hits, a
          float64-checked graze counting as agreeing); the plain walks
          in a subprocess beside phases 2d-3c (see 14a);
       c. the CLI as a subprocess on the teapot stand-in (512 x 288,
          depth 65, 1 spp), run beside 12d: exit 0, four outputs, a
          finite positive mean;
          then one warm-up and two timed 1-spp waves in process at 1280 x
          720: s/wave,
          Mrays/s, F's launches per wave, no plain walk on the card;
       d. the small furball over a checkerboard rectangle, tiled and
          packed, card against CPU image means within 2%, with A, B and
          F's triangle leaf (tiled) and F's four instances (packed)
          launched.
  13. instanced meshes through kernel G (csrc/instanced.cu, the two-level
     walk, one thread per ray over the instances), on the instanced
     stand-in of hairpt_torch.scene.scene_xmls (64 instances of the
     2,808-triangle teapot, a bitmap floor in a normal map, a bump-mapped
     heightfield, a deformable pair under the curvature texture):
       a. G against its plain version on a contiguous eighth of the
          rays of the camera and first-bounce waves (1280 x 720), closest
          and any hit, t, prim, instance and the flag bit for bit; timed
          beside its plain version (one call on those rays), its bound
          and two yardsticks: the JAX package's structure carried over
          (per instance, the box test and object ray as tensor ops and
          one launch of F) and the 64 instances flattened into one
          179,712-triangle mesh walked by F; the plain walks in a
          subprocess (PlainWalks) beside 13b and 13c's CLI;
       b. a small render (96 x 54, depth 5) on the card and with the
          plain versions on the CPU: image means within 2%, G launched;
       c. the CLI as a subprocess at 512 x 288 and 1 spp, run beside
          13b (wall time, its logged build and render seconds), then one
          warm-up and two timed 1-spp waves at 1280 x 720, depth 65
          (s/wave, Mrays/s, G's and F's launches per wave, no plain
          version on the card).
  14. the per-ray and the blocked BVH walks, kernels H (csrc/perray.cu,
     one thread per ray, kernel F's loop over the BVHArrays) and I
     (csrc/blocked.cu, one CTA per block of 256 rays sharing one node
     index), and motion blur:
       a. H against its plain version on a contiguous quarter of the
          rays of the furball's camera and first-bounce waves (hair leaf;
          run in phase 2) and on every ray of the teapot stand-in's
          (triangle leaf), closest and any hit, bit for bit, and against
          F on the same tree and primitives on every ray; I
          against its plain version on every 61st block of the furball's
          camera wave and every block of the teapot's waves, bit for
          bit, and against H on every ray of all four waves; each timed
          beside its plain version, F (for H) and the bound; the
          furball's plain walks (with 12b's) in a subprocess
          (PlainWalks: chip_smoke.py --plain-walks PATH, on the card)
          beside phases 2d-3c, which time nothing, their results read
          back before phase 4;
       b. the motion stand-in (scene_xmls.motion: the furball's hair at
          quality 14, the moving teapot, the deformable pair, 16
          animated instances, the animated camera; shutter [0, 1],
          1024^2, spp 4, depth 65): a warm-up wave, then its four shutter
          times timed (s/wave, rays/wave, Mrays/s, the rebuild's and the
          re-pose's host seconds per shutter time, A, B, F and G
          launches per wave); the small stand-in card against CPU;
       c. the CLI on the motion stand-in as a subprocess at 512^2 and 1
          spp, one shutter time, run beside 14b's small renders (wall
          time, its logged build and render seconds);
       d. one wave of the full-width furball (after phase 5) and the
          teapot stand-in with traversal 'perray' and 'blocked' (s/wave,
          H's and I's launches), and the small furball over the
          checkerboard with both, card against CPU.
  15. the tiled query's options and the area and delta lights:
       a. (run in phase 2, on its waves) kernel A over the 32-segment
          sub-cluster boxes ([6, 4C], subcull's phase A) against its
          plain version on EVERY tile of both waves (2a's rules), timed
          beside the cluster-box instance and its bound; subcull,
          short_t (4x the median cluster-box diagonal) and two_round
          (256) through the whole query, closest and any hit (two_round
          closest only, as in hairpt), against the default query: hit
          flags and pids equal on >= 99.99% of the rays, t equal where
          the pids are, every differing ray's hit outside its segment's
          sub-cluster box; each query timed beside the default;
       b. (run after phase 4) phase 4's render with traversal
          'tiled_sub' and with tiled_short > 0: a warm-up and a timed
          wave each, A's instances and B's launches;
       c. the lit stand-in (scene_xmls.lit: the furball's hair at
          quality 14, a rectangle and a sphere area light, a spot and a
          point light, the sunsky; 1024^2, depth 65): the CLI at 512^2
          and 1 spp (exit 0, four outputs, a finite positive mean);
          load_scene against SceneBuilder (config and every tensor
          equal); a warm-up and one timed 1-spp wave (s/wave, Mrays/s,
          A, B and F launches); at 64^2 the render and the diffuse
          gradient card
          against CPU and PRB against the differentiable mode at depth 3.
  16. rendering and the inverse step across GPUs, the materials cell and
     the other sensors:
       a. (run after phase 7) NCCL at world size 1 (a local TCP
          rendezvous): parallel.mesh.render_sharded on phase 4's furball
          (a warm-up and a timed wave, s/wave, A and B launched) against
          the same wave in one process in plain pixel order (rtol 2e-4,
          atol 2e-5 on all but 0.01% of the values, means within 1e-5);
          the film all_reduce's ms (1024^2 x 4 floats); make_train_step
          on phase 6's scene (depth 16, the diffuse table) against the
          one-process step (1e-5 relative);
       b. two gloo ranks on the one card (subprocesses of this script
          with a time limit): a 256^2 furball (6,000 fibers) at depth 8,
          the sharded render and one train step against 16a's world-size-1
          results with 16a's bounds;
       c. (at the end) the materials stand-in (scene_xmls.materials: the
          XML furball at quality 14 ringed by one sphere per surface BSDF
          family and wrapper material, a checkerboard floor, the sunsky,
          a thin lens; 1024^2, depth 65): the CLI at 512^2 and 1 spp
          (exit 0, four outputs, a finite positive mean); load_scene
          against SceneBuilder (config, camera and every tensor equal);
          a warm-up and one timed 1-spp wave (s/wave, Mrays/s, tiled
          queries per wave, A, B and F launches); at 64^2 the render and
          the diffuse gradient card against CPU and PRB against the
          differentiable mode at depth 3;
       d. the small materials stand-in (32^2, depth 4) through each
          other sensor kind, image means card against CPU within 2%.
  17. participating media and subsurface scattering:
       a. kernel J (csrc/woodcock.cu, Woodcock tracking, one thread per
          lane) against its plain loop on EVERY lane of the media cell's
          camera wave and first-bounce wave (1,048,576 lanes each), delta
          tracking (t, is_med) and ratio tracking (tr) bit for bit (or
          within J_FLAG_SHARE / J_MAX_ULPS), through the dense grid and
          through its block-sparse form (make_hgrid_from_dense), each
          timed beside its plain version and its bound;
       b. the media stand-in (scene_xmls.media: the XML furball at
          quality 14 in a 256^3 smoke grid, HG g 0.3, the sunsky,
          volpath; 1024^2, depth 65): the CLI at 512^2 and 2 spp (exit 0,
          four outputs, a finite positive mean); load_scene against
          SceneBuilder (config, every tensor and the medium equal); a
          warm-up and two timed 1-spp waves (s/wave, Mrays/s, tiled
          queries per wave, A, B and J launches, no plain version on the
          card); at 64^2 the render card against CPU, with the dense grid
          and with its block-sparse form (J launched on the card);
       c. the bounded-media stand-in (scene_xmls.bounded: the furball in
          a null-bounded fog sphere, a dielectric sphere with an interior
          medium, an hk sphere, a checkerboard floor; volpath, 1024^2):
          a warm-up and two timed waves (A, B and F launches); at 64^2
          card against CPU;
       d. the subsurface stand-ins (scene_xmls.subsurface: the teapot
          stand-in under a dipole and under single scattering): the
          dipole prepass's seconds at 1280 x 720, and both at 64 x 36
          card against CPU.
  18. the light tracers and the photon maps:
       a. kernel K (csrc/photons.cu, one thread per lane, a count and a
          write pass) against its plain version, the pair lists bit for
          bit: surface mode on every lane of the lit stand-in's camera
          wave (1024^2) against a photon map of 1 << 16 photons, 4
          bounces, radius 0.3; beam mode on 262,144 contiguous lanes of
          the fog stand-in's camera wave (32 steps) against its volume
          photon map (1 << 15 photons, 8 bounces, radius 0.25); each timed
          beside its plain version and its bound;
       b. the lit stand-in (1024^2, the XML furball's 1,008,000 segments,
          the area, spot and point lights, the sunsky, depth 65) through
          ptracer (its 8 waves of 32,768 paths), bdpt (one wave, s and t
          up to 4), vpl (one wave, 128 paths x 3 bounces), ppm and sppm
          (one pass each, 16,384 photons): s per wave or pass, tiled
          queries, the launches of A, B, F and K; each one's small render
          (64^2, hair quality 0.1, depth 8, fewer photons and paths) card
          against CPU first, the warm-up;
       c. the fog stand-in (scene_xmls.fog: the furball hair, a point
          light and the sunsky in a homogeneous fog, photonmapper): one
          timed wave of the volumetric photon map at 1024^2 (both photon
          passes, the beam estimate and the surface gather: K's two
          modes); its small render card against CPU;
       d. the CLI on the lit XML with --integrator bdpt and on the fog
          XML with its photonmapper, at 512^2 and 1 spp.
  19. the rest of the CLI's integrators but mlt and motion:
       a. kernel L (csrc/irrcache.cu, the Ward-weighted cache
          interpolation, one thread per lane) against its plain version
          (which adds the records in L's order) on every valid lane of the
          floor cell's 1024^2 camera wave against that cell's cache of
          4,096 records, with the (8, 16) grid's gradients and without
          (the cosine-ray cache): has_cut exactly, e within L_RTOL (bit for
          bit expected); each timed beside its plain version and bound;
       b. the floor cell (scene/furball.py furball_floor_scene at quality
          14, 1024^2, depth 65: the furball's 1,008,000 segments over the
          checkerboard floor, in the sunsky) through irrcache with each
          cache: the cache pass's seconds, one timed wave after a warm-up,
          tiled queries, the launches of A, B, F and L; its small render
          (64^2, quality 0.1, 256 records) card against CPU first;
       c. the XML furball at 1024^2: one timed wave each of direct, ao and
          field (shNormal, albedo), adaptive with 2 + 2 samples (hairpt:
          8 + 24), A and B launched in each; each one's small render and
          multichannel's four channels card against CPU;
       d. pssmlt and erpt on it with 16,384 chains and 8 mutations
          (hairpt: 64 and 16): s per Metropolis step, tiled queries per
          step; the pool's eval_u card against CPU on the small furball
          (4,096 lanes); the small renders card against CPU;
       e. render_spectral on the Marschner furball at 1024^2, 6 bins, 1
          spp: s per band and the band tables' s; a small render with
          Cauchy dispersion on the materials stand-in (its dielectrics)
          card against CPU;
       f. the CLI with --integrator multichannel on the furball XML (the
          .npy channels checked) and --integrator irrcache on the teapot
          XML, at 512 across and 1 spp.
  20. path-space MLT, the manifold walk and motion vectors (kernels A, B
      and F; no new kernel):
       a. (inside 16c, on its loaded 1024^2 materials cell) render_mlt's
          chains at hairpt's 16,384 chains and 16-fold pool, the
          mutations cut from 64 to MLT_MUTATIONS (two rounds of lens,
          caustic, manifold, bidir, mchain): the pool's s, s per round
          and per mutation kind, tiled queries and A, B, F launches per
          round, the share of chains matching each kind's pattern and
          its mean acceptance; a finite image with a positive mean;
       b. the small materials cell (64^2, hair quality 0.1, depth 8, 1,024
          chains, one round) card against CPU: the pool pick and each
          step's ok flags and acceptance on >= 97% of the lanes, the image
          means within 2%;
       c. the manifold walk on tests/test_manifold.py's mirror sphere
          (4,096 lanes) on the card and the CPU: the converged share, the
          distance to the analytic reflection point, ok flags and x card
          against CPU;
       d. (inside 14b, on its loaded motion cell) one render_motion wave
          with 'd' at 1024^2 (s per wave, A, B, F and G launches); 'rd'
          and 'ttd' on tests/test_motion.py's scenes at 64^2 card against
          CPU (+inf pixels equal, finite ones within 1e-3 px);
       e. the CLI with --integrator mlt on the teapot XML (hairpt's
          defaults) and --integrator motion on the motion XML, at 512
          across, beside 20b-20d.
  21. the irawan woven cloth and the CLI's banded render, --stats,
      --profile, util and import (kernels A, B and F; no new kernel):
       a. the cloth stand-in (the furball on a noisy-twill floor before a
          plain-weave backdrop, 1024^2, depth 65, hair quality 14): the
          share of the camera wave's lanes on cloth (>= 20%), a warm-up
          and two timed 1-spp waves: s/wave, tiled queries and A, B, F
          launches per wave, a finite image with a positive mean;
       b. card against CPU (the CPU side a --cpu-refs subprocess beside
          21a): cloth_resolve, gather, eval_pdf and sample on 2^20 lanes
          of both weaves at uvs in [-2, 3]^2, pack_cloth's spec_norm, and
          a small cloth render (64^2, depth 8, the hair left out, 32
          spp, means within 2%);
       c. the CLI beside 21a: render --bands 64 --stats (its EXR against
          an in-process 1-spp render within half precision, its 'Rays
          traced' equal to an in-process banded render's); --profile on
          a 64^2 render at depth 8 (the Chrome trace holds kernels A and
          B); util
          resample of the banded EXR to 512^2 on the card against --cpu
          (1e-5); import of a COLLADA document and a 64^2 render of the
          imported scene on the card.
  22. the image codecs, the film's annotations and banner, and the
      leftovers (kernels A and B; no new kernel):
       a. (started beside 21a) the CLI on phase 11's furball XML with two
          label[x, y] strings (film, sampler and integrator keys; the
          render time) and the banner, 1024^2, 1 spp, --stats, -o
          furball.jpg: exit 0, Rays traced > 0, A's and B's launches in
          its log; the JPEG decoded on the card against the tonemapped
          .npy beside it outside the text (PSNR >= JPEG_PSNR_MIN), each
          label's glyphs near white in the decode (label_drawn);
       b. write_jpg of that 1024^2 frame on the card and with
          device="cpu": byte-identical files; read_image of the file on
          both: the same pixels, within JPEG_PSNR_MIN of the source;
          encode and decode seconds on each side;
       c. (after phase 15b, on phase 4's scene) a warm-up round and 4
          timed rounds of one 1-spp wave of make_li_fn with no knob and
          under each ablate knob (nonee, noshadow, cheapshade, nosort) in
          turn: per knob the
          median s/wave and the median of each round's ratio to its
          round's no-knob wave, each with its least and most; rays,
          tiled queries, A's and B's launches; a finite image every wave;
       d. core/distribution, core/numerics and spectrum's helpers on 2^20
          lanes, card against CPU with the CPU tests' bounds.
  23. the image formats the JAX package reads and writes through PIL
      (kernels A, B and F; no new kernel: the readers run on the host, a
      JPEG's block stage is integer tensor code):
       a. (started beside 21a) the CLI on phase 11's furball XML under a
          1024 x 512 lossy WebP envmap, over a floor whose bitmap is an
          LZW TIFF (predictor 2) in a lossless WebP normal map, a GIF
          backdrop and an arithmetic-coded JPEG heightfield, 1024^2, 1
          spp, --stats, -o frame.tif: exit 0, Rays traced > 0, A's, B's
          and F's launches in its log, each texture's decode seconds from
          its log; frame.tif read back by the port's TIFF reader equals
          the 8-bit tonemapped .npy;
       b. every fixture of tests/torch_images (one per reader branch)
          decoded on the card machine equals PIL's committed array; the
          JPEG block stage on the card equals the CPU's; seconds per file;
          the fixtures of a size users have (large.json, decoded in a
          process of their own started beside 23a) equal PIL's array by
          shape and SHA-256;
       c. 23a's XML at 64^2 (hair quality 0.1, depth 8, 1 spp) loaded and
          rendered on the card and on the CPU: every texture table equal,
          the image means within MEAN_RTOL.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line. Without CUDA the script exits non-zero at once.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time

# a hang anywhere exits non-zero with every thread's traceback
faulthandler.dump_traceback_later(1150, exit=True)

T_START = time.time()

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per (ray, cluster) slab test and per (ray, segment)
# cylinder test, counted from the kernels' source (a division and a
# square root count as one each): the tiled kernels' test (B, C, D) and
# kernel E's, which divides twice and evaluates the miter planes at the
# hit points
SLAB_FLOPS = 30
CYL_FLOPS = 90
# f32 operations of kernel A's tile test of one (tile, cluster) pair,
# counted from tiled.cu's tile_pass the same way (per face 2 subtractions,
# 4 products, 6 min/max; 2 min/max per axis; 4 across the axes, 2 to
# widen, 3 compares)
TILE_TEST_FLOPS = 87
CHUNK_CYL_FLOPS = 105

# tolerances of the kernel checks, with their reasons:
#  te: exact or one bf16 step apart (the kernel and the plain version
#      truncate the same f32 minimum; one step allows for a different
#      f32 rounding of the slab arithmetic)
TE_MAX_BF16_STEPS = 1
#  t_pmax: 1e-6 relative (the same f32 entry t, bit-equal expected)
TPMAX_RTOL = 1e-6
#  pid: >= 99.9% equal (exact equality expected with --fmad=false; the
#       margin covers equal-t ties that rounding could reorder)
PID_MIN_AGREE = 0.999
#  t: 1e-5 relative where both hit
T_RTOL = 1e-5
#  small render, card vs CPU: image means within 2% (paths can diverge
#  where CPU and GPU transcendentals round differently)
MEAN_RTOL = 0.02
#  octet bits of kernel A: exact (the same hit predicate as te)
#  kernels C and D: t and pid bit for bit in both modes (the same
#      arithmetic without fused multiply-adds on both sides, the same
#      per-slot or per-entry stop rule, and a tie rule, the largest pid
#      at the minimum t, that no order of the lanes or warps changes)
#  kernel E: t and pid bit for bit (the same arithmetic without fused
#      multiply-adds on both sides, and a tie rule, the largest pid at the
#      minimum t, that no order of the lanes or warps changes)
#  swept phase A: slots, cnt and n_hit exactly (the same slab arithmetic,
#      and a selection by a unique integer key)
#  gradients, card vs CPU (phase 3b): the loss within GRAD_LOSS_RTOL
#      relative and each gradient component within GRAD_REL of the
#      largest |g| of the CPU's gradients (the CPU tests' bounds for the
#      port against the JAX package: the paths that diverge where float32
#      rounding flips a sampling decision move both a little)
GRAD_LOSS_RTOL = 1e-3
GRAD_REL = 1e-2
#  path-replay backprop vs the differentiable mode (phase 3b): the loss
#      within PRB_LOSS_RTOL relative and each parameter's gradient within
#      PRB_REL of its largest |g| (the JAX package's tests/test_prb.py)
PRB_LOSS_RTOL = 1e-4
PRB_REL = 5e-3
#  the tile chunk of the plain phase B versions on the card (phase 2)
PLAIN_TILES_ON_CARD = 16384
#  the diffuse albedo bench.py's backward phase starts from
BENCH_P0 = (0.143016, 0.0156076, 1.80928e-05)
#  octet and stream queries against the dense query at full width: hit
#  flags equal, pid >= PID_MIN_AGREE equal (the modes break equal-t ties
#  by slot order, kernel B by the largest pid), t within T_RTOL


class SmokeFailure(Exception):
    pass


def log(msg):
    print(f"[smoke {time.time() - T_START:7.1f}s] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_scene(quality, res, depth, spp, device, q=2048, traversal="tiled",
                nee_rr=0.01, material="roughplastic"):
    from hairpt_torch.scene.furball import furball_scene
    return furball_scene(quality=quality, res=res, depth=depth, spp=spp,
                         device=device, q=q, traversal=traversal,
                         nee_rr=nee_rr, material=material)


def with_config(scene, **fields):
    import dataclasses
    return scene._replace(config=dataclasses.replace(scene.config, **fields))


def cuda_ms(fn, reps, warm=True):
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(n_bytes, flops):
    """(least time in ms, 'bytes' or 'operations')."""
    tb, to = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(tb, to) * 1e3, ("operations" if to >= tb else "bytes")


def compare(t_k, p_k, t_p, p_p):
    """(pid agreement, max t rel diff, max |t diff|) where both hit."""
    agree = float((p_k == p_p).float().mean())
    both = (p_k >= 0) & (p_p >= 0)
    if not bool(both.any()):
        return agree, 0.0, 0.0
    d = (t_k - t_p)[both].abs()
    rel = d / t_p[both].abs().clamp(min=1e-30)
    return agree, float(rel.max()), float(d.max())


def waves(scene):
    """A camera wave and a first-bounce wave of the scene, as Ray, for the
    tiled kernels (the bounce wave Morton-sorted, as the tiled queries sort
    it) and for the swept ones (in lane order, as the swept traversal
    takes its rays, the missed lanes at infinity as the integrator leaves
    them, plus the dead lanes a later bounce parks at the camera hits with
    mint = maxt = 0); and the camera wave's hit fraction."""
    import numpy as np
    import torch
    from hairpt_torch.core import rng, warps
    from hairpt_torch.core.math import Ray
    from hairpt_torch.integrators import common
    from hairpt_torch.models import sensors
    from hairpt_torch.ops import intersect_tiled as itiled

    cfg = scene.config
    arr = scene.arrays
    dev = arr.hair.p0.device
    pixel = torch.as_tensor(common.block_swizzle(cfg.width, cfg.height),
                            device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jitter = smp.next_2d(0)
    pos = torch.stack([(smp.pixel % cfg.width).float() + jitter[:, 0],
                       (smp.pixel // cfg.width).float() + jitter[:, 1]], -1)
    cam_ray = sensors.sample_ray(scene.camera, pos)
    hit = common.scene_intersect(arr, cam_ray, cfg.tiled_q)
    n = pixel.shape[0]
    u = torch.as_tensor(np.random.default_rng(7).random((n, 2)),
                        dtype=torch.float32, device=dev)
    d = warps.square_to_uniform_sphere(u)
    d = torch.where((torch.sum(d * hit.geo_n, -1) < 0)[:, None], -d, d)
    o = hit.p + hit.geo_n * cfg.ray_eps
    o = torch.where(hit.valid[:, None], o, cam_ray.o)
    bounce = Ray(o=o, d=d, mint=torch.zeros(n, device=dev),
                 maxt=torch.where(hit.valid, float("inf"), 0.0))
    v = hit.valid
    nv = int(v.sum())
    dead = Ray(o=hit.p[v], d=d[v], mint=torch.zeros(nv, device=dev),
               maxt=torch.zeros(nv, device=dev))
    # the swept bounce wave's missed lanes start where the integrator puts
    # them: at the miss's hit point o + d * inf (+-inf or NaN components)
    bounce_sw = bounce._replace(o=hit.p + hit.geo_n * cfg.ray_eps)
    swept = {"camera": cam_ray, "bounce": bounce_sw, "dead": dead}
    bounce, _ = itiled._morton_sort_rays(arr.hair_swept, bounce)
    return ({"camera": cam_ray, "bounce": bounce}, swept,
            float(v.float().mean()))


def check_kernel_a(r8, bounds, name):
    """Phase 2a: kernel A (both instances) against its plain version on
    EVERY tile of a wave (one plain call with emit_oct serves both), and
    the share of (tile, cluster) pairs that pass its tile test.
    Returns (te, t_pmax, oct, max |te diff|, facts for the kernels line)."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    T, C = r8.shape[0], bounds.shape[1]
    te_k, tpm_k = tk.cull_phase_a(r8, bounds)
    te_o, tpm_o, oct_k = tk.cull_phase_a(r8, bounds, emit_oct=True)
    require(torch.equal(te_o.view(torch.int16), te_k.view(torch.int16))
            and torch.equal(tpm_o.view(torch.int32), tpm_k.view(torch.int32)),
            f"{name}: kernel A's two instances differ in te or t_pmax")
    out = {}
    plain_ms = cuda_ms(lambda: out.update(p=tk.cull_phase_a_plain(
        r8, bounds, emit_oct=True)), 1, warm=False)
    te_p, tpm_p, oct_p = out.pop("p")
    a = te_k.view(torch.int16).int() & 0x7FFF
    b = te_p.view(torch.int16).int() & 0x7FFF
    steps = int((a - b).abs().max())
    words = int((te_k.view(torch.int16) != te_p.view(torch.int16)).sum())
    fin = torch.isfinite(te_p.float())
    te_err = float((te_k.float() - te_p.float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    both_neg = (tpm_k < 0) & (tpm_p < 0)
    tp_rel = float(torch.where(both_neg, 0.0, (tpm_k - tpm_p).abs()
                               / tpm_p.abs().clamp(min=1e-30)).max())
    oct_bad = int((oct_k != oct_p).sum())
    del te_p, tpm_p, oct_p
    # the tile test's passes (its plain version) beside the clusters the
    # tiles' rays enter
    n_pass = sum(int(tk.group_cull_plain(r8[t0:t0 + 256], bounds).sum())
                 for t0 in range(0, T, 256))
    live = r8[:, 7, :] > r8[:, 6, :]
    live_t = int(live.any(1).sum())
    hit_t = int(fin.sum())
    # the per-ray tests this wave needs: each live ray of a tile against
    # the clusters some ray of the tile enters
    n_ray_tests = int((fin.sum(1) * live.sum(1)).sum())
    facts = dict(live_tiles=live_t, tile_pass=n_pass,
                 tile_pass_share=n_pass / max(1, live_t * C),
                 tile_union_share=hit_t / max(1, live_t * C),
                 ray_tests=n_ray_tests, plain_ms=plain_ms)
    log(f"{name}: kernel A vs plain on all {T} tiles (plain {plain_ms:.1f} "
        f"ms): max bf16 step diff {steps}, te words differing {words}, max "
        f"|te diff| {te_err:.3g}, max t_pmax rel diff {tp_rel:.3g}, octet "
        f"words differing {oct_bad}; candidates/tile "
        f"{float(fin.sum(1).float().mean()):.1f}")
    log(f"{name}: of the live (tile, cluster) pairs the tile test passes "
        f"{facts['tile_pass_share']:.5f} ({n_pass} of {live_t * C}), rays "
        f"enter {facts['tile_union_share']:.5f} ({hit_t}); per-ray tests "
        f"needed {n_ray_tests}")
    require(steps <= TE_MAX_BF16_STEPS,
            f"{name}: kernel A te differs by {steps} bf16 steps")
    require(tp_rel <= TPMAX_RTOL,
            f"{name}: kernel A t_pmax rel diff {tp_rel}")
    require(oct_bad == 0, f"{name}: kernel A octet words differ in "
            f"{oct_bad} entries")
    return te_k, tpm_k, oct_k, te_err, facts


def check_octet_kernels(name, kname, kern, plain, T, dev):
    """Phase 2a: kernel C or D against its plain version on EVERY tile of
    a wave, closest and any hit: t and pid bit for bit (the same stop
    rules and the same tie rule on both sides). Logs the share of (ray,
    slot) or (ray, entry) pairs that pass the kernel's cull. Returns the
    closest-hit facts: the kernel's culled pairs, the plain version's
    tests and blocks (its work) and its time, and the largest |t diff|
    where both sides hit, over both modes."""
    import torch
    out = {}
    t_err = 0.0
    for any_hit in (False, True):
        mode = "any" if any_hit else "closest"
        pairs = torch.zeros((T,), dtype=torch.int32, device=dev)
        t_k, p_k = kern(any_hit, pairs)
        res = {}
        ms = cuda_ms(lambda: res.update(p=plain(any_hit)), 1, warm=False)
        t_p, p_p, blocks, tests = res.pop("p")
        n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
        n_p = int((p_k != p_p).sum())
        hits_equal = bool(torch.equal(p_k >= 0, p_p >= 0))
        n_pairs, n_tests = int(pairs.long().sum()), int(tests.sum())
        unit = "slot" if kname == "phase_b_oct" else "entry"
        log(f"{name}: {kname} {mode} on all {T} tiles (plain {ms:.1f} ms): "
            f"t bits differing {n_t}, pid differing {n_p}, hit flags equal "
            f"{hits_equal}, hits {int((p_k >= 0).sum())}; (ray, {unit}) "
            f"pairs the octet bits leave {n_tests}, passing the cull "
            f"{n_pairs} ({n_pairs / max(1, n_tests):.4f}); blocks "
            f"{int(blocks.sum())}")
        require(n_t == 0 and n_p == 0,
                f"{name}/{mode}: {kname} differs from its plain version on "
                f"{n_t} t and {n_p} pid of {64 * T} rays")
        t_err = max(t_err, compare(t_k, p_k, t_p, p_p)[2])
        if not any_hit:
            out = dict(pairs=n_pairs, tests=n_tests,
                       blocks=int(blocks.sum()), plain_ms=ms)
    out["t_err"] = t_err
    return out


def check_kernels(scene, wv, report):
    """Phase 2a: kernel A (both instances) against its plain version on
    every tile of each wave, and kernels C and D on every tile of the
    routing that A's octet instance gives."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    q = scene.config.tiled_q
    qo = min(max(256, q // 4), q)     # the JAX default stream_qo
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    seg = sw.seg_rows_t
    errs = {k: 0.0 for k in ("cull_phase_a", "cull_phase_a_oct", "phase_b",
                             "phase_b_oct", "stream_phase_b")}
    for name, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        r8 = itiled.rays8_of(ray_p)
        T = r8.shape[0]
        te_k, tpm_k, oct_k, te_err, facts = check_kernel_a(r8, bounds, name)
        errs["cull_phase_a"] = max(errs["cull_phase_a"], te_err)
        errs["cull_phase_a_oct"] = max(errs["cull_phase_a_oct"], te_err)
        key = ks.keys(te_k)
        oargs = itiled._tile_slots(key, ks, q, oct=oct_k)
        oargs = oargs[:4] + oargs[6:] + (r8, tpm_k, seg, bounds)
        sargs = itiled._octet_streams(key, ks, oct_k, q, qo)[:6] \
            + (r8, tpm_k, seg, bounds)
        w = dict(r8=r8, te=te_k, tpm=tpm_k, oct=oct_k, a=facts,
                 oargs=oargs, sargs=sargs)
        w["c"] = check_octet_kernels(
            name, "phase_b_oct",
            lambda ah, pairs: tk.phase_b_oct(*oargs, ah, pairs_out=pairs),
            lambda ah: tk.phase_b_oct_plain(*oargs[:8], ah,
                                            return_work=True), T, r8.device)
        w["d"] = check_octet_kernels(
            name, "stream_phase_b",
            lambda ah, pairs: tk.stream_phase_b(*sargs, ah,
                                                pairs_out=pairs),
            lambda ah: tk.stream_phase_b_plain(*sargs[:9], ah,
                                               return_work=True), T,
            r8.device)
        errs["phase_b_oct"] = max(errs["phase_b_oct"], w["c"]["t_err"])
        errs["stream_phase_b"] = max(errs["stream_phase_b"], w["d"]["t_err"])
        report[name] = w
    return errs


def check_phase_b(scene, report, errs):
    """Phase 2a: kernel B against its plain version on EVERY tile of both
    waves (the first routing pass of each whole wave), closest and any
    hit: hit flags exactly equal, pid >= PID_MIN_AGREE (the differing
    pids are counted), t within T_RTOL, slots run equal on every tile.
    Logs the share of (ray, slot) pairs that pass the kernel's slot cull.
    Returns the plain version's time on the camera wave (closest hit)."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    q = scene.config.tiled_q
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    plain_ms = None
    for name, w in report.items():
        slots, cnt, tmin, tscale, ov, _ = itiled._tile_slots(
            ks.keys(w["te"]), ks, q)
        args = (slots, cnt, tmin, tscale, w["r8"], w["tpm"], sw.seg_rows_t)
        T = slots.shape[0]
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            pairs = torch.zeros((T,), dtype=torch.int32, device=slots.device)
            t_k, p_k, run_k = tk.phase_b(*args, bounds, any_hit, True,
                                         pairs_out=pairs)
            out = {}
            ms = cuda_ms(lambda: out.update(p=tk.phase_b_plain(
                *args, any_hit, True)), 1, warm=False)
            if name == "camera" and not any_hit:
                plain_ms = ms
            t_p, p_p, run_p = out["p"]
            agree, t_rel, t_abs = compare(t_k, p_k, t_p, p_p)
            hits_equal = bool(torch.equal(p_k >= 0, p_p >= 0))
            run_equal = float((run_k == run_p).float().mean())
            n_run = int(run_k.long().sum())
            n_pairs = int(pairs.long().sum())
            log(f"{name}: kernel B {mode} on all {T} tiles ({n_run} slots "
                f"run, overflow tiles {ov}; plain {ms:.1f} ms): hit flags "
                f"equal {hits_equal}, pid agree {agree:.6f} "
                f"({int((p_k != p_p).sum())} differ), max t rel diff "
                f"{t_rel:.3g}, slots run equal {run_equal:.4f}; (ray, slot) "
                f"pairs passing the slot cull {n_pairs} of {64 * n_run} "
                f"({n_pairs / max(1, 64 * n_run):.4f})")
            require(hits_equal and agree >= PID_MIN_AGREE
                    and t_rel <= T_RTOL and run_equal == 1.0,
                    f"{name}/{mode}, all tiles: kernel B hit flags equal "
                    f"{hits_equal}, pid agreement {agree}, t rel diff "
                    f"{t_rel}, slots run equal {run_equal}")
            errs["phase_b"] = max(errs["phase_b"], t_abs)
            if not any_hit:
                w["t_plain"] = t_p
                w["cull_pairs"] = n_pairs
                w["cull_share"] = n_pairs / max(1, 64 * n_run)
    return plain_ms


def bcd_bound(n_blk, n_tst, T, K):
    """The least time of a phase-B kernel (B, C or D) on one routed wave
    that runs n_tst (ray, cluster) tests of K lanes and reads n_blk
    (tile, cluster) segment blocks, each once per tile, with the tiles'
    rays, bounds and results. (ms, 'bytes'/'operations')."""
    return bound_ms(n_blk * (16 * K * 4 + 4) + T * (8 * 64 * 4 + 64 * 4 + 12)
                    + T * 64 * 8, n_tst * K * CYL_FLOPS)


def function_work(r8, slots, cnt, bounds, best):
    """The work the closest-hit function of kernels B, C and D needs on
    one routed wave, from the plain side: each ray against each routed
    slot (s < cnt) whose cluster box, widened by BOX_PAD, it enters before
    its closest hit (slot_cull_plain up to min(maxt, best), best: the
    plain version's t), and the (tile, slot) blocks at least one such ray
    needs. Returns (pairs, blocks)."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    T, q = slots.shape
    maxt_eff = torch.minimum(r8[:, 7], best)
    lo, hi = bounds[:3].T, bounds[3:].T                      # [C, 3]
    used = torch.arange(q, device=slots.device)[None] < cnt[:, None]
    tt, ss = torch.nonzero(used, as_tuple=True)
    n_pairs = n_blk = 0
    for c0 in range(0, tt.numel(), 1 << 16):
        ti = tt[c0:c0 + (1 << 16)]
        cid = (slots[ti, ss[c0:c0 + (1 << 16)]] & tk.CID_MASK).long()
        n = tk.slot_cull_plain(r8[ti], lo[cid], hi[cid], maxt_eff[ti]).sum(1)
        n_pairs += int(n.sum())
        n_blk += int((n > 0).sum())
    return n_pairs, n_blk


def time_kernels(scene, report, errs, times):
    """The kernels line's entries of kernels A (both instances, timed
    here), B, C and D (times: phase_b_times) at the camera wave's shapes,
    with their bounds and plain versions' times."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    cam = report["camera"]
    r8 = cam["r8"]
    T = r8.shape[0]
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    out = []

    def entry(name, src, replaces, err, ms, plain, bound, **more):
        b, by = bound
        log(f"{name}: {ms:.3f} ms at the camera wave (bound {b:.3f} ms, by "
            f"{by}), plain {plain:.1f} ms")
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=0, max_abs_err=err,
                        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=None, tiles=T, **more))

    # kernel A on both waves, beside two bounds: the work these inputs
    # need (bound_ms: each live (tile, cluster) tile test, and each live
    # ray against the clusters some ray of its tile enters, against the
    # bytes) and the
    # dense bound (every live tile's 64 rays x every cluster)
    plain_a = cuda_ms(lambda: tk.cull_phase_a_plain(r8, bounds), 1,
                      warm=False)
    for emit in (False, True):
        kname = "cull_phase_a_oct" if emit else "cull_phase_a"
        more = {}
        for wname in ("camera", "bounce"):
            w = report[wname]
            f = w["a"]
            ms = cuda_ms(lambda: tk.cull_phase_a(w["r8"], bounds,
                                                 emit_oct=emit), 5)
            n_bytes = T * 8 * 64 * 4 + 6 * C * 4 + T * 64 * 4 \
                + T * C * (6 if emit else 2)
            work = bound_ms(n_bytes, f["live_tiles"] * C * TILE_TEST_FLOPS
                            + f["ray_tests"] * SLAB_FLOPS)
            dense = bound_ms(n_bytes, f["live_tiles"] * 64 * C * SLAB_FLOPS)
            log(f"{kname}, {wname} wave: {ms:.3f} ms; bound from this "
                f"wave's work {work[0]:.3f} ms by {work[1]} "
                f"({ms / work[0]:.1f}x), dense bound {dense[0]:.3f} ms by "
                f"{dense[1]} ({ms / dense[0]:.2f}x)")
            pre = "" if wname == "camera" else "bounce_"
            more.update({f"{pre}ms": ms, f"{pre}bound_ms": work[0],
                         f"{pre}bound_by": work[1],
                         f"{pre}dense_bound_ms": dense[0],
                         f"{pre}tile_pass_share": f["tile_pass_share"],
                         f"{pre}tile_union_share": f["tile_union_share"]})
        ms = more.pop("ms")
        b = (more.pop("bound_ms"), more.pop("bound_by"))
        entry(kname, "hairpt_torch/csrc/tiled.cu",
              "hairpt/ops/pallas_tiled.py:882",
              errs[kname], ms, cam["a"]["plain_ms"] if emit else plain_a, b,
              bound_basis="bound_ms: the work of this run's camera wave "
              "(live (tile, cluster) tile tests, live-ray tests of the "
              "clusters the tile's rays enter); dense_bound_ms: every live tile's 64 rays "
              "x every cluster", **more)

    # B, C and D on both waves (phase_b_times)
    for kname, src, line in (("phase_b", "tiled.cu", 396),
                             ("phase_b_oct", "octets.cu", 286),
                             ("stream_phase_b", "octets.cu", 621)):
        c = dict(times["camera"][kname])
        more = {f"bounce_{k}": v for k, v in times["bounce"][kname].items()}
        ms, plain = c.pop("ms"), c.pop("plain_ms")
        bound = (c.pop("bound_ms"), c.pop("bound_by"))
        entry(kname, f"hairpt_torch/csrc/{src}",
              f"hairpt/ops/pallas_tiled.py:{line}", errs[kname], ms, plain,
              bound, bound_basis="bound_ms: the closest-hit function's work "
              "on this run's wave, the same for B, C and D (each ray against "
              "each routed cluster whose widened box it enters before its "
              "closest hit, x K lane tests, from slot_cull_plain on the "
              "plain side; the (tile, cluster) blocks at least one such ray "
              "needs, or D's distinct blocks where fewer); work_bound_ms: "
              "this kernel's own work (the pairs passing its cull, the "
              "blocks it reads)", **c, **more)
    return out


def phase_b_times(scene, report, plain_b):
    """Kernels B, C and D on the first routing pass of each whole wave
    (C and D on the routing of A's octet instance): each one's time beside
    the bound of the function they compute (function_work, the same for
    the three) and beside its own work (the pairs passing its cull, the
    blocks it reads). plain_b: kernel B's plain version's time on the
    camera wave (check_phase_b)."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    ks = itiled.KeySpace(C)
    seg = sw.seg_rows_t
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    out = {}
    for name, w in report.items():
        slots, cnt, tmin, tscale, _, _ = itiled._tile_slots(
            ks.keys(w["te"]), ks, q)
        args = (slots, cnt, tmin, tscale, w["r8"], w["tpm"], seg, bounds)
        T = slots.shape[0]
        run = tk.phase_b(*args, False, True)[2]
        n_slots = int(run.long().sum())
        ms = {"phase_b": cuda_ms(lambda: tk.phase_b(*args), 5),
              "phase_b_oct": cuda_ms(lambda: tk.phase_b_oct(*w["oargs"]), 5),
              "stream_phase_b": cuda_ms(
                  lambda: tk.stream_phase_b(*w["sargs"]), 5)}
        c, d = w["c"], w["d"]
        f_pairs, f_blk = function_work(w["r8"], slots, cnt, bounds,
                                       w["t_plain"])
        n_blk = min(f_blk, d["blocks"])
        b, by = bcd_bound(n_blk, f_pairs, T, K)
        log(f"{name} wave, first routing pass: the function's work "
            f"{f_pairs} (ray, cluster) pairs, {f_blk} blocks they need "
            f"({d['blocks']} distinct blocks of D's walks); bound "
            f"{b:.3f} ms by {by}")
        own = {"phase_b": (n_slots, w["cull_pairs"],
                           plain_b if name == "camera" else None),
               "phase_b_oct": (c["blocks"], c["pairs"], c["plain_ms"]),
               "stream_phase_b": (d["blocks"], d["pairs"], d["plain_ms"])}
        out[name] = {}
        for kname, (k_blk, k_pairs, plain) in own.items():
            wb, wby = bcd_bound(k_blk, k_pairs, T, K)
            log(f"{name} wave, first routing pass: {kname} {ms[kname]:.3f} "
                f"ms, {ms[kname] / b:.1f}x the function's bound; its own "
                f"work {k_pairs} pairs past its cull "
                f"({k_pairs / max(1, f_pairs):.3f}x the function's), "
                f"{k_blk} blocks read: {wb:.3f} ms by {wby} "
                f"({ms[kname] / wb:.1f}x)")
            out[name][kname] = dict(
                ms=ms[kname], plain_ms=plain, bound_ms=b, bound_by=by,
                work_bound_ms=wb, work_bound_by=wby,
                ray_cluster_tests=k_pairs, blocks_read=k_blk,
                function_tests=f_pairs, function_blocks=n_blk)
        out[name]["phase_b"]["cull_pass_share"] = w["cull_share"]
        log(f"{name} wave: of 64 x {n_slots} (ray, slot) pairs B's cull "
            f"passes {w['cull_share']:.4f}; of the pairs the octet bits "
            f"leave C's passes {c['pairs'] / max(1, c['tests']):.4f} "
            f"({c['tests']} left), D's {d['pairs'] / max(1, d['tests']):.4f}"
            f" ({d['tests']} left)")
    return out


def check_modes(scene, wv):
    """Phase 2b: whole waves through the octet and stream modes against
    the dense query. Returns the octet kernels' launches over these
    queries."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    q = scene.config.tiled_q
    ref = {}
    for name, ray in wv.items():
        itiled.tiled_closest_hit(sw, ray, q_max=q)      # warm
        torch.cuda.synchronize()
        t0 = time.time()
        ref[name] = (itiled.tiled_closest_hit(sw, ray, q_max=q),
                     itiled.tiled_any_hit(sw, ray, q_max=q))
        torch.cuda.synchronize()
        log(f"{name} wave, dense: closest and any-hit queries "
            f"{time.time() - t0:.3f} s")
    torch.cuda.synchronize()
    tk.reset_counts()
    for kw in (dict(octets=True), dict(streams=True)):
        label = "octets" if "octets" in kw else "streams"
        for name, ray in wv.items():
            (t_d, p_d), occ_d = ref[name]
            itiled.STATS.update(max_passes=0, overflow_tiles=0)
            t0 = time.time()
            t_m, p_m = itiled.tiled_closest_hit(sw, ray, q_max=q, **kw)
            occ_m = itiled.tiled_any_hit(sw, ray, q_max=q, **kw)
            torch.cuda.synchronize()
            secs = time.time() - t0
            passes, ovf = (itiled.STATS["max_passes"],
                           itiled.STATS["overflow_tiles"])
            agree, t_rel, _ = compare(t_m, p_m, t_d, p_d)
            hits_equal = bool(torch.equal(p_m >= 0, p_d >= 0))
            occ_equal = bool(torch.equal(occ_m, occ_d))
            log(f"{name} wave, {label}: closest and any-hit queries "
                f"{secs:.3f} s; closest hit flags "
                f"equal {hits_equal}, pid agree {agree:.6f}, max t rel diff "
                f"{t_rel:.3g}; over the two queries at most {passes} "
                f"completion passes, {ovf} overflow tiles; any-hit flags "
                f"equal {occ_equal} "
                f"({int(occ_m.sum())} occluded)")
            require(hits_equal and occ_equal and agree >= PID_MIN_AGREE
                    and t_rel <= T_RTOL,
                    f"{name}/{label}: differs from the dense query")
    torch.cuda.synchronize()
    launches = dict(tk.OCT_LAUNCHES)
    require(all(v > 0 for v in launches.values()),
            f"an octet-mode kernel was not launched: {launches}")
    require(all(v == 0 for v in tk.OCT_PLAIN_ON_CUDA.values()),
            f"plain versions ran on CUDA tensors: {tk.OCT_PLAIN_ON_CUDA}")
    return launches


def swept_a_work(sw, ray):
    """The work the swept phase A needs on a wave, from the plain side:
    (tiles, clusters passing the tile test, per-ray tests: each ray the
    kernel tests (not padding, not one never_hits_plain skips) against
    the clusters some ray of its 64-ray tile enters, the (tile, cluster)
    pairs rays enter). The hits are _phase_a_dense's
    (torch.minimum/maximum), in pieces of 64 tiles."""
    import torch
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk

    N, C = ray.o.shape[0], sw.cl_lo.shape[0]
    T = -(-N // 64)
    dev = ray.o.device
    lo = [sw.cl_lo[None, :, ax] for ax in range(3)]
    hi = [sw.cl_hi[None, :, ax] for ax in range(3)]
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    n_pass = n_union = n_tests = 0
    for t0 in range(0, T, 64):
        r0, r1 = t0 * 64, min(N, (t0 + 64) * 64)
        m = r1 - r0
        o = ray.o[r0:r1]
        inv = tk._inv_dir(ray.d[r0:r1])
        tn, tf = tk._slab([o[:, None, ax] for ax in range(3)],
                          [inv[:, None, ax] for ax in range(3)], lo, hi)
        hit = (tn <= tf) & (tf >= ray.mint[r0:r1, None]) \
            & (tn <= ray.maxt[r0:r1, None])
        pad = -m % 64
        hit = torch.cat([hit, torch.zeros((pad, C), dtype=torch.bool,
                                          device=dev)])
        union = hit.view(-1, 64, C).any(dim=1)                # [t, C]
        tested = ~pk.never_hits_plain(o, inv, ray.mint[r0:r1],
                                      ray.maxt[r0:r1])
        ranged = torch.cat([tested, torch.zeros(pad, dtype=torch.bool,
                                                device=dev)]).view(-1, 64)
        n_union += int(union.sum())
        n_tests += int((union.sum(1) * ranged.sum(1)).sum())
        r8 = torch.zeros((union.shape[0] * 64, 8), device=dev)
        r8[:m, 0:3], r8[:m, 3:6] = o, ray.d[r0:r1]
        r8[:m, 6], r8[:m, 7] = ray.mint[r0:r1], ray.maxt[r0:r1]
        r8 = r8.view(-1, 64, 8).transpose(1, 2).contiguous()
        n_pass += int(tk.group_cull_plain(r8, bounds, ranged).sum())
    return T, n_pass, n_tests, n_union


def check_swept_kernels(scene, wv):
    """Phase 2c: the swept phase-A kernel against _phase_a_dense on EVERY
    ray of the camera, first-bounce and dead-lane waves (slots, cnt and
    n_hit equal), and kernel E against its plain version on every
    E_PLAIN_SHARE-th of the live chunks the kernel's slots route, and on
    a tail of dead chunks (t and pid bit for bit); both timed on the
    camera and bounce waves beside their bounds, with the shares that
    set kernel E's work. Returns the two entries of the kernels line."""
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import phaseb_kernels as pk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    NS = K // pk.SUBK
    cfg = scene.config
    p_max, ch = cfg.swept_pmax, cfg.swept_chunk
    ent_a = dict(name="swept_phase_a", route="cuda",
                 source="hairpt_torch/csrc/swept_cull.cu",
                 replaces="hairpt/ops/intersect_swept.py:220 (XLA, no "
                 "Pallas kernel)", launches=0, max_abs_err=0.0,
                 library_ms=None)
    ent_e = dict(name="phase_b_chunks", route="cuda",
                 source="hairpt_torch/csrc/phaseb.cu",
                 replaces="hairpt/ops/pallas_phaseb.py:38", launches=0,
                 max_abs_err=0.0, library_ms=None)
    for name, ray in wv.items():
        N = ray.o.shape[0]
        # -- the phase-A kernel, every ray --
        slots, cnt, n_hit = pk.swept_phase_a(sw, ray, p_max)
        out = {}
        plain_a = cuda_ms(lambda: out.update(p=iswept._phase_a_dense(
            sw, ray, p_max, return_n_hit=True)), 1, warm=False)
        s_p, c_p, n_p = out.pop("p")
        eq = [bool(torch.equal(x, y)) for x, y in
              ((slots, s_p), (cnt, c_p), (n_hit, n_p))]
        del s_p, c_p, n_p
        o_l = pk.tile_order(sw, ray).long()        # the kernel's tiles
        T, n_pass, n_tests, n_union = swept_a_work(
            sw, Ray(ray.o[o_l], ray.d[o_l], ray.mint[o_l], ray.maxt[o_l]))
        log(f"{name}: swept phase A on all {N} rays (plain {plain_a:.1f} "
            f"ms): slots equal {eq[0]}, cnt equal {eq[1]}, n_hit equal "
            f"{eq[2]}; boxes entered per ray "
            f"{float(n_hit.float().mean()):.2f}, rays over p_max "
            f"{int((n_hit > p_max).sum())}; in the kernel's tiles the tile "
            f"test passes {n_pass / (T * C):.5f} of the (tile, cluster) "
            f"pairs, rays enter {n_union / (T * C):.5f}; per-ray tests "
            f"needed {n_tests}")
        require(all(eq), f"{name}: the swept phase-A kernel differs from "
                f"_phase_a_dense (slots, cnt, n_hit equal: {eq})")
        if name == "camera":
            # key lists past the kernel's shared-memory list (SMEM_K): the
            # camera rays enter 45 boxes on average, many over SMEM_K
            pl = pk.SMEM_K + 32
            long_k = pk.swept_phase_a(sw, ray, pl)
            long_p = iswept._phase_a_dense(sw, ray, pl, return_n_hit=True)
            eq_l = [bool(torch.equal(x, y)) for x, y in zip(long_k, long_p)]
            ms_l = cuda_ms(lambda: pk.swept_phase_a(sw, ray, pl), 3)
            log(f"{name}: swept phase A with p_max {pl} (key lists in "
                f"global memory) on all {N} rays: slots, cnt, n_hit equal "
                f"{eq_l}; rays keeping over {pk.SMEM_K} "
                f"{int((long_p[1] > pk.SMEM_K).sum())}; {ms_l:.3f} ms")
            require(all(eq_l) and int((long_p[1] > pk.SMEM_K).sum()) > 0,
                    f"{name}: the swept phase-A kernel with p_max {pl} "
                    f"differs from _phase_a_dense ({eq_l}) or keeps no list "
                    f"past SMEM_K")
            ent_a["long_list_p_max"], ent_a["long_list_ms"] = pl, ms_l
            del long_k, long_p
        # -- kernel E, every live chunk and a tail of dead ones --
        chunk_cl, chunk_ray, _, _ = iswept._route_pairs(slots, C, ch)
        rays = iswept._chunk_rays(ray, chunk_ray)
        n = chunk_cl.shape[0]
        live = torch.nonzero(chunk_cl >= 0).squeeze(1)
        idx = torch.cat([live[_strided(live.numel(), E_PLAIN_SHARE)],
                         torch.arange(n - min(n, 64), n,
                                      device=live.device)]).unique()
        t_k, p_k = pk.phase_b_chunks(chunk_cl, rays, sw.seg_rows_t,
                                     sw.sub_lo, sw.sub_hi)
        out = {}
        plain_e = cuda_ms(lambda: out.update(p=pk.phase_b_chunks_plain(
            chunk_cl[idx], rays[idx], sw.seg_rows_t)), 1, warm=False)
        t_p, p_p = out.pop("p")
        t_bits = bool(torch.equal(t_k[idx].view(torch.int32),
                                  t_p.view(torch.int32)))
        pid_eq = bool(torch.equal(p_k[idx], p_p))
        n_live = live.numel()
        lr = rays[live]                                    # [n_live, 8, ch]
        pad_l = lr[:, 7] < lr[:, 6]
        n_lanes = n_live * ch
        n_valid = n_lanes - int(pad_l.sum())
        dead_l = int(((lr[:, 7] <= lr[:, 6]) & ~pad_l).sum())
        n_enter = 0
        for c0 in range(0, n_live, 16384):
            cl = chunk_cl[live[c0:c0 + 16384]].long()
            n_enter += int(pk.sub_cull_plain(
                lr[c0:c0 + 16384], sw.sub_lo.view(C, NS, 3)[cl],
                sw.sub_hi.view(C, NS, 3)[cl], pad=0.0).sum())
        n_cl = int(torch.unique(chunk_cl[live]).numel())
        log(f"{name}: kernel E on {n} chunks ({n_live} live) vs plain on "
            f"{idx.numel()} (plain {plain_e:.1f} ms): t bits equal {t_bits},"
            f" pid equal {pid_eq}, hits {int((p_k[idx] >= 0).sum())}; of the "
            f"{n_lanes} lanes of live chunks {1 - n_valid / n_lanes:.4f} are "
            f"padding, {dead_l / n_lanes:.4f} dead rays; of the {n_valid} "
            f"(ray, chunk) pairs x {NS} sub-clusters, rays enter "
            f"{n_enter / max(1, n_valid * NS):.4f} of the sub-boxes")
        require(t_bits and pid_eq, f"{name}: kernel E differs from its "
                f"plain version (t bits equal {t_bits}, pid equal {pid_eq})")
        del t_p, p_p, lr
        if name == "dead":
            continue
        # -- times and bounds --
        ms_a = cuda_ms(lambda: pk.swept_phase_a(sw, ray, p_max), 5)
        ms_sort = cuda_ms(lambda: pk.tile_order(sw, ray), 5)
        b_a = bound_ms(N * 32 + C * 24 + N * (p_max * 4 + 12),
                       T * C * TILE_TEST_FLOPS + n_tests * SLAB_FLOPS)
        d_a = bound_ms(N * 32 + C * 24 + N * (p_max * 4 + 12),
                       N * C * SLAB_FLOPS)
        ms_e = cuda_ms(lambda: pk.phase_b_chunks(
            chunk_cl, rays, sw.seg_rows_t, sw.sub_lo, sw.sub_hi), 5)
        e_bytes = n * (4 + ch * 8) + n_live * 8 * ch * 4 \
            + n_cl * (16 * K * 4 + NS * 24)
        b_e = bound_ms(e_bytes, n_enter * pk.SUBK * CHUNK_CYL_FLOPS)
        d_e = bound_ms(n * (4 + 8 * ch * 4 + ch * 8) + n_live * 16 * K * 4,
                       n_live * ch * K * CHUNK_CYL_FLOPS)
        log(f"swept_phase_a, {name} wave: {ms_a:.3f} ms, its ray order "
            f"(tile_order) {ms_sort:.3f} ms of it; bound from this wave's "
            f"work {b_a[0]:.3f} ms by {b_a[1]} "
            f"({ms_a / b_a[0]:.1f}x), dense bound {d_a[0]:.3f} ms; plain "
            f"{plain_a:.1f} ms")
        log(f"phase_b_chunks, {name} wave: {ms_e:.3f} ms; bound from this "
            f"wave's work {b_e[0]:.3f} ms by {b_e[1]} "
            f"({ms_e / b_e[0]:.1f}x), dense bound {d_e[0]:.3f} ms by "
            f"{d_e[1]}; plain {plain_e:.1f} ms")
        pre = "" if name == "camera" else "bounce_"
        ent_a.update({f"{pre}ms": ms_a, f"{pre}plain_ms": plain_a,
                      f"{pre}order_ms": ms_sort,
                      f"{pre}bound_ms": b_a[0], f"{pre}bound_by": b_a[1],
                      f"{pre}dense_bound_ms": d_a[0],
                      f"{pre}tile_pass_share": n_pass / (T * C),
                      f"{pre}tile_union_share": n_union / (T * C),
                      f"{pre}ray_tests": n_tests})
        ent_e.update({f"{pre}ms": ms_e, f"{pre}plain_ms": plain_e,
                      f"{pre}bound_ms": b_e[0], f"{pre}bound_by": b_e[1],
                      f"{pre}dense_bound_ms": d_e[0],
                      f"{pre}chunks": n, f"{pre}live_chunks": n_live,
                      f"{pre}padding_share": 1 - n_valid / n_lanes,
                      f"{pre}dead_share": dead_l / n_lanes,
                      f"{pre}sub_enter_share":
                      n_enter / max(1, n_valid * NS)})
        del rays
    ent_a["bound_basis"] = ("bound_ms: the work of this run's wave in the "
                            "kernel's tiles (every (tile, cluster) tile "
                            "test, each ray against the clusters some ray "
                            "of its tile enters); dense_bound_ms: every "
                            "ray x every cluster; ms: the wrapper, its ray "
                            "order (order_ms) included")
    ent_e["bound_basis"] = ("bound_ms: the work of this run's wave (each "
                            "ray of a live chunk against the 32 segments "
                            "of each sub-cluster box it enters, the "
                            "segment blocks of the clusters used once); "
                            "dense_bound_ms: every lane of every live "
                            "chunk x K segments")
    return [ent_a, ent_e]


def small_reference(reset_all):
    """Phase 3: a small furball on the card and on the CPU, both
    traversals; the swept render on the card goes through both swept
    kernels (the phase-A kernel in its lowest-ids branch: C = 57)."""
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import phaseb_kernels as pk

    for trav in ("tiled", "swept"):
        means = {}
        for dev in ("cuda", "cpu"):
            s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                            q=64, traversal=trav)
            reset_all()
            means[dev] = float(path.render(s, spp=1).mean())
            if trav == "swept" and dev == "cuda":
                launches = dict(pk.LAUNCHES)
                plain = dict(pk.PLAIN_ON_CUDA)
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"small furball, {trav} (600 fibers, 64^2, depth 8): image mean "
            f"card {means['cuda']:.6f}, CPU {means['cpu']:.6f}, rel diff "
            f"{rel:.3g}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small {trav} render: card and CPU means differ by {rel}")
    log(f"small swept render on the card: launches {launches}, plain "
        f"versions on CUDA tensors {plain}")
    require(all(v > 0 for v in launches.values())
            and all(v == 0 for v in plain.values()),
            f"the small swept render did not go through both swept kernels: "
            f"launches {launches}, plain {plain}")


GRAD_PARAMS = ("diffuse", "specular", "alpha", "eta")


def scan_ad_grad(scene, params, sample=0, backward=True):
    """The differentiable mode's mean(nan_to_num(radiance)) over the film
    (lanes in pixel order, one sample index) and its gradient with
    respect to each tensor of `params` (a material field, or a tensor
    broadcast over it). Returns (loss, {name: grad},
    forward rays); no gradient and no graph when backward is False."""
    import torch
    from hairpt_torch.integrators import inverse, path

    cfg = scene.config
    dev = scene.arrays.hair.p0.device
    n = cfg.width * cfg.height
    leaves = {k: v.detach().clone().requires_grad_(backward)
              for k, v in params.items()}
    mats = scene.arrays.materials
    fields = {k: v.expand_as(getattr(mats, k)) for k, v in leaves.items()}
    li = path.make_li_fn(scene, differentiable=True)
    with torch.set_grad_enabled(backward):
        arrs = inverse.apply_params_arrays(scene.arrays, fields,
                                           scene.marschner_rows)
        rad, _, n_rays = li(arrs, torch.arange(n, device=dev),
                            torch.full((n,), sample, dtype=torch.int64,
                                       device=dev))
        loss = torch.nan_to_num(rad, nan=0.0, posinf=0.0,
                                neginf=0.0).mean()
    if backward:
        loss.backward()
    return (float(loss.detach()), {k: v.grad for k, v in leaves.items()},
            float(n_rays))


def small_gradients(reset_all):
    """Phase 3b: the small furball's gradients on the card against the
    plain versions on the CPU, and path-replay backprop against the
    differentiable mode on the card."""
    import torch
    from hairpt_torch.integrators import inverse
    from hairpt_torch.ops import tiled_kernels as tk

    res = {}
    for dev in ("cuda", "cpu"):
        s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                        q=64)
        m = s.arrays.materials
        reset_all()
        t0 = time.time()
        res[dev] = scan_ad_grad(s, {k: getattr(m, k) for k in GRAD_PARAMS})
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(tk.LAUNCHES)
            plain = dict(tk.PLAIN_ON_CUDA)
        log(f"small furball gradients on {dev} (64^2, depth 8): loss "
            f"{res[dev][0]:.6f}, " + ", ".join(
                f"{k} {v.detach().cpu().numpy().ravel()}"
                for k, v in res[dev][1].items())
            + f" ({time.time() - t0:.1f}s)")
    (l_k, g_k, _), (l_p, g_p, _) = res["cuda"], res["cpu"]
    scale = max(float(g.abs().max()) for g in g_p.values())
    err = max(float((g_k[k].cpu() - g_p[k]).abs().max()) for k in g_p)
    rel = abs(l_k - l_p) / max(abs(l_p), 1e-12)
    log(f"card vs CPU: loss rel diff {rel:.3g}, largest gradient diff "
        f"{err:.3g} = {err / scale:.3g} of the largest |g| ({scale:.4g}); "
        f"launches {launches}, plain versions on CUDA tensors {plain}")
    require(rel <= GRAD_LOSS_RTOL and err <= GRAD_REL * scale,
            f"small furball gradients: card and CPU differ (loss {rel}, "
            f"gradient {err / scale} of the largest)")
    require(all(v > 0 for v in launches.values())
            and all(v == 0 for v in plain.values()),
            f"the card's gradients did not go through kernels A and B: "
            f"{launches}, plain {plain}")
    for depth in (3, 5):
        s = with_config(bench_scene(quality=0.1, res=64, depth=depth, spp=1,
                                    device="cuda", q=64, nee_rr=0.0),
                        rr_depth=999)
        m = s.arrays.materials
        params = {k: getattr(m, k) for k in GRAD_PARAMS}
        l_s, g_s, _ = scan_ad_grad(s, params)
        n = s.config.width * s.config.height
        pix = torch.arange(n, device=s.arrays.hair.p0.device)
        l_r, g_r = inverse.make_prb_loss_grad(s)(
            s.arrays, params, pix, torch.zeros_like(pix))
        l_r = float(l_r)
        rels = {k: float((g_r[k] - g_s[k]).abs().max()
                         / g_s[k].abs().max().clamp(min=1e-12))
                for k in params}
        lrel = abs(l_r - l_s) / max(abs(l_s), 1e-12)
        log(f"PRB vs the differentiable mode on the card, depth {depth}: "
            f"loss {l_r:.6f} / {l_s:.6f} (rel {lrel:.3g}), gradient diffs "
            f"over each one's largest |g|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()))
        require(lrel <= PRB_LOSS_RTOL and max(rels.values()) <= PRB_REL,
                f"depth {depth}: PRB differs from the differentiable mode "
                f"(loss {lrel}, gradients {rels})")


def bench_backward(scene, reset_all):
    """Phase 6: bench.py's backward phase. Returns its facts."""
    import numpy as np
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    s = with_config(scene, max_depth=16)
    p0 = {"diffuse": torch.tensor(BENCH_P0, device=s.arrays.hair.p0.device)}
    t0 = time.time()
    scan_ad_grad(s, p0, sample=0)
    torch.cuda.synchronize()
    log(f"fwd+bwd warm-up step {time.time() - t0:.2f}s")
    reset_all()
    itiled.STATS.update(queries=0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    steps = [scan_ad_grad(s, p0, sample=i) for i in (1, 2)]
    torch.cuda.synchronize()
    secs = (time.time() - t0) / len(steps)
    launches = dict(tk.LAUNCHES)
    queries = itiled.STATS["queries"]
    plain = dict(tk.PLAIN_ON_CUDA, **tk.OCT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, g, rays = steps[-1]
    g = g["diffuse"].cpu().numpy()
    # the same steps' forward passes alone
    reset_all()
    itiled.STATS.update(queries=0)
    for i in (1, 2):
        scan_ad_grad(s, p0, sample=i, backward=False)
    torch.cuda.synchronize()
    fwd_launches = dict(tk.LAUNCHES)
    fwd_queries = itiled.STATS["queries"]
    log(f"fwd+bwd train step (1024^2, depth 16): {secs * 1e3:.1f} ms/step "
        f"({rays:.0f} fwd rays) -> {rays / secs / 1e6:.4f} Mrays/s; loss "
        f"{steps[-1][0]:.6f}, gradient {g}, |g| {np.abs(g).sum():.4g}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"launches over the 2 timed fwd+bwd steps {launches} ({queries} "
        f"queries); over their forward passes alone {fwd_launches} "
        f"({fwd_queries} queries); plain versions on CUDA tensors and "
        f"octet kernels: {plain}")
    require(bool(np.isfinite(g).all()) and bool(np.abs(g).sum() > 0),
            f"fwd+bwd gradient {g}")
    require(all(v > 0 for v in launches.values()),
            f"the fwd+bwd step did not launch kernels A and B: {launches}")
    require(launches == fwd_launches and queries == fwd_queries,
            f"the backward pass traced queries again: {launches} against "
            f"{fwd_launches} for the forward passes alone")
    require(all(v == 0 for v in plain.values()),
            f"plain versions or octet kernels ran: {plain}")
    return dict(ms=secs * 1e3, rays=rays, grad=g, peak=peak,
                launches={k: v / len(steps) for k, v in launches.items()})


def prb_step(scene, reset_all, bwd):
    """Phase 7: path-replay backprop at depth 65 with nee_rr 0. Returns
    its facts."""
    import numpy as np
    import torch
    from hairpt_torch.integrators import inverse
    from hairpt_torch.ops import tiled_kernels as tk

    s = with_config(scene, max_depth=65, nee_rr=0.0)
    cfg = s.config
    n = cfg.width * cfg.height
    dev = s.arrays.hair.p0.device
    pix = torch.arange(n, device=dev)
    params = {"diffuse": torch.tensor(BENCH_P0, device=dev).expand_as(
        s.arrays.materials.diffuse)}
    f = inverse.make_prb_loss_grad(s)
    t0 = time.time()
    f(s.arrays, params, pix, torch.zeros_like(pix))
    torch.cuda.synchronize()
    log(f"PRB warm-up step {time.time() - t0:.2f}s")
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    loss, d = f(s.arrays, params, pix, torch.ones_like(pix))
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(tk.LAUNCHES)
    plain = dict(tk.PLAIN_ON_CUDA)
    g = d["diffuse"].sum(0).cpu().numpy()
    log(f"PRB step (1024^2, depth 65, nee_rr 0): {secs * 1e3:.1f} ms/step; "
        f"loss {float(loss):.6f}, gradient {g}, |g| {np.abs(g).sum():.4g}; "
        f"peak memory {peak / 2**30:.2f} GiB (phase 6, depth 16: "
        f"{bwd['peak'] / 2**30:.2f} GiB); launches {launches}")
    require(bool(np.isfinite(g).all()), f"PRB gradient {g}")
    require(np.sign(g[0]) == np.sign(bwd["grad"][0]) and g[0] != 0,
            f"PRB's red diffuse gradient {g[0]} and phase 6's "
            f"{bwd['grad'][0]} differ in sign")
    require(all(v == 0 for v in plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return dict(ms=secs * 1e3, grad=g, peak=peak, launches=launches)


# the four hair BSDF kinds of phase 3c: the furball's material row with
# each kind (registry ids: KAJIYAKAY 12, MARSCHNER 13, MARSCHNERDIELECTRIC
# 14, MARSCHNER_PURE 23)
HAIR_KINDS = {"kajiyakay": 12, "marschner": 13, "marschnerdielectric": 14,
              "marschner_pure": 23}
HAIR_GRAD_PARAMS = ("sigma_a", "beta_r")
#  the inverse twin (phase 10): the loss's mean over the last third of the
#      steps must be below step 1's loss. Step 0's first render takes
#      sample index 0, as the target's first sample does, so its loss is
#      biased low; hairpt's examples/inverse_furball.py gives the same
#      curve at these defaults (PERF.md §6), so step 1 is the first loss
#      of renders independent of the target
# hair scenes of phase 2d at quality 14 (the furball's full width): the
# straight-hair curtain (800 x 14 fibers x 24 segments) and the four
# hair-curl clumps (220 x 14 fibers each x 48 segments), framed as
# hairpt/scene/hairgen.py says the reference scenes frame them
HAIR_QUALITY = 14


def hair_row(kind, **over):
    row = dict(kind=kind, sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, eta=1.55,
               alpha=0.2, dist=0, diffuse=BENCH_P0)
    row.update(over)
    return row


def hair_scene(name, device="cuda", res=1024):
    """Phase 2d's scenes, MARSCHNER_PURE materials, no emitter (the
    kernel checks trace camera and first-bounce waves only)."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.core.math import matrix_lookat
    from hairpt_torch.film.film import Film
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene import hairgen
    from hairpt_torch.scene.scene import SceneBuilder

    b = SceneBuilder(device=device)
    if name == "straight":
        m = b.add_material(**hair_row(HAIR_KINDS["marschner_pure"]))
        b.add_fibers(hairgen.gen_straight_hair(
            n_fibers=int(800 * HAIR_QUALITY)), m)
        eye, at = (0.0, 16.5, -25.0), (0.0, 8.5, 0.0)
    else:
        # black, red, brown and blonde clumps
        for fs, sa in zip(hairgen.gen_hair_curl(
                n_fibers_per_clump=int(220 * HAIR_QUALITY)),
                ((3.0, 3.4, 4.2), (0.3, 1.6, 2.6), (1.2, 1.6, 2.4),
                 (0.15, 0.25, 0.45))):
            b.add_fibers(fs, b.add_material(**hair_row(
                HAIR_KINDS["marschner_pure"], sigma_a=sa)))
        eye, at = (0.0, 5.9, 17.0), (0.0, 6.0, 0.0)
    cam = Camera.perspective(matrix_lookat(eye, at, (0, 1, 0)), 35.0, res,
                             res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, m_res, res), tiled_q=2048,
                   traversal="tiled")


def check_hair_kernels(name, errs):
    """Phase 2d: kernels A and B against their plain versions on every
    tile of a hair scene's camera and first-bounce waves, with phase 2a's
    rules."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    t0 = time.time()
    scene = hair_scene(name)
    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    rad = float(scene.arrays.hair.radius[0])
    log(f"{name} hair scene: {scene.arrays.hair.p0.shape[0]} segments, "
        f"radius {rad:.6g}, C={C}, built in {time.time() - t0:.1f}s")
    wv, _, hit_frac = waves(scene)
    log(f"{name} waves: camera hit fraction {hit_frac:.4f}")
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    report = {}
    for wname, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        r8 = itiled.rays8_of(ray_p)
        te, tpm, _, te_err, _ = check_kernel_a(r8, bounds,
                                               f"{name} {wname}")
        errs["cull_phase_a"] = max(errs["cull_phase_a"], te_err)
        report[f"{name} {wname}"] = dict(r8=r8, te=te, tpm=tpm)
    check_phase_b(scene, report, errs)
    require(hit_frac > 0.001, f"{name}: the camera wave hits no hair "
            f"({hit_frac}) to check the kernels on")


def small_hair_renders(reset_all):
    """Phase 3c: the small furball with each hair kind on the card and on
    the CPU (image means within MEAN_RTOL); sigma_a and beta_r gradients
    card against CPU at depth 8 (phase 3b's bounds) for both Marschner
    modes; PRB against the differentiable mode on the card for
    MARSCHNER_PURE at depths 3 and 5."""
    import torch
    from hairpt_torch.integrators import inverse, path
    from hairpt_torch.ops import tiled_kernels as tk

    for kname, kind in HAIR_KINDS.items():
        means = {}
        for dev in ("cuda", "cpu"):
            s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                            q=64, material=hair_row(kind))
            reset_all()
            means[dev] = float(path.render(s, spp=1).mean())
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = dict(tk.LAUNCHES)
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"small furball, {kname}: image mean card {means['cuda']:.6f}, "
            f"CPU {means['cpu']:.6f}, rel diff {rel:.3g}; launches "
            f"{launches}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small {kname} render: card and CPU means differ by {rel}")
        require(all(v > 0 for v in launches.values()),
                f"the small {kname} render did not launch A and B")
    for kname in ("marschner_pure", "marschner"):
        res = {}
        for dev in ("cuda", "cpu"):
            s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                            q=64, material=hair_row(HAIR_KINDS[kname]))
            m = s.arrays.materials
            reset_all()
            res[dev] = scan_ad_grad(s, {k: getattr(m, k)
                                        for k in HAIR_GRAD_PARAMS})
            if dev == "cuda":
                torch.cuda.synchronize()
                plain = dict(tk.PLAIN_ON_CUDA)
        (l_k, g_k, _), (l_p, g_p, _) = res["cuda"], res["cpu"]
        scale = max(float(g.abs().max()) for g in g_p.values())
        err = max(float((g_k[k].cpu() - g_p[k]).abs().max()) for k in g_p)
        rel = abs(l_k - l_p) / max(abs(l_p), 1e-12)
        log(f"small {kname} furball gradients (64^2, depth 8): loss card "
            f"{l_k:.6f}, CPU {l_p:.6f} (rel {rel:.3g}); card "
            + ", ".join(f"{k} {v.cpu().numpy().ravel()}"
                        for k, v in g_k.items())
            + ", CPU " + ", ".join(f"{k} {v.numpy().ravel()}"
                                   for k, v in g_p.items())
            + f"; largest diff {err / max(scale, 1e-30):.3g} of the "
            f"largest |g|")
        require(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
                f"{kname}: non-finite gradient on the card")
        require(rel <= GRAD_LOSS_RTOL and err <= GRAD_REL * scale,
                f"small {kname} gradients: card and CPU differ (loss {rel},"
                f" gradient {err / max(scale, 1e-30)} of the largest)")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
    for depth in (3, 5):
        s = with_config(bench_scene(quality=0.1, res=64, depth=depth, spp=1,
                                    device="cuda", q=64, nee_rr=0.0,
                                    material="marschner"), rr_depth=999)
        m = s.arrays.materials
        params = {k: getattr(m, k) for k in HAIR_GRAD_PARAMS}
        l_s, g_s, _ = scan_ad_grad(s, params)
        n = s.config.width * s.config.height
        pix = torch.arange(n, device=s.arrays.hair.p0.device)
        l_r, g_r = inverse.make_prb_loss_grad(s)(
            s.arrays, params, pix, torch.zeros_like(pix))
        l_r = float(l_r)
        rels = {k: float((g_r[k] - g_s[k]).abs().max()
                         / g_s[k].abs().max().clamp(min=1e-12))
                for k in params}
        lrel = abs(l_r - l_s) / max(abs(l_s), 1e-12)
        log(f"Marschner PRB vs the differentiable mode on the card, depth "
            f"{depth}: loss {l_r:.6f} / {l_s:.6f} (rel {lrel:.3g}), "
            f"gradient diffs over each one's largest |g|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()))
        require(lrel <= PRB_LOSS_RTOL and max(rels.values()) <= PRB_REL,
                f"Marschner depth {depth}: PRB differs from the "
                f"differentiable mode (loss {lrel}, gradients {rels})")


def hair_backward(scene, reset_all):
    """Phase 9: bench.py's backward phase on the Marschner furball: the
    gradient of mean(nan_to_num(radiance)) at depth 16 with respect to
    sigma_a [1, 3] and beta_r [1] (the tables recomputed from them).
    Returns its facts."""
    import numpy as np
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    s = with_config(scene, max_depth=16)
    m = s.arrays.materials
    p0 = {k: getattr(m, k) for k in HAIR_GRAD_PARAMS}
    t0 = time.time()
    scan_ad_grad(s, p0, sample=0)
    torch.cuda.synchronize()
    log(f"Marschner fwd+bwd warm-up step {time.time() - t0:.2f}s")
    reset_all()
    itiled.STATS.update(queries=0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    steps = [scan_ad_grad(s, p0, sample=i) for i in (1, 2)]
    torch.cuda.synchronize()
    secs = (time.time() - t0) / len(steps)
    launches = dict(tk.LAUNCHES)
    queries = itiled.STATS["queries"]
    plain = dict(tk.PLAIN_ON_CUDA, **tk.OCT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, g, rays = steps[-1]
    g = {k: v.cpu().numpy().ravel() for k, v in g.items()}
    reset_all()
    itiled.STATS.update(queries=0)
    for i in (1, 2):
        scan_ad_grad(s, p0, sample=i, backward=False)
    torch.cuda.synchronize()
    fwd_launches = dict(tk.LAUNCHES)
    fwd_queries = itiled.STATS["queries"]
    log(f"Marschner fwd+bwd train step (1024^2, depth 16): "
        f"{secs * 1e3:.1f} ms/step ({rays:.0f} fwd rays) -> "
        f"{rays / secs / 1e6:.4f} Mrays/s; loss {steps[-1][0]:.6f}, "
        f"gradients {g}; peak memory {peak / 2**30:.2f} GiB")
    log(f"launches over the 2 timed fwd+bwd steps {launches} ({queries} "
        f"queries); over their forward passes alone {fwd_launches} "
        f"({fwd_queries} queries); plain versions on CUDA tensors and "
        f"octet kernels: {plain}")
    require(all(bool(np.isfinite(v).all()) for v in g.values())
            and any(bool(np.abs(v).sum() > 0) for v in g.values()),
            f"Marschner fwd+bwd gradients {g}")
    require(all(v > 0 for v in launches.values()),
            f"the Marschner step did not launch kernels A and B: "
            f"{launches}")
    require(launches == fwd_launches and queries == fwd_queries,
            f"the backward pass traced queries again: {launches} against "
            f"{fwd_launches} for the forward passes alone")
    require(all(v == 0 for v in plain.values()),
            f"plain versions or octet kernels ran: {plain}")
    return dict(ms=secs * 1e3, rays=rays, grad=g, peak=peak,
                launches={k: v / len(steps) for k, v in launches.items()})


def inverse_twin():
    """Phase 10: the inverse-rendering twin at the example's defaults
    (res 256, 6,000 fibers, spp 2, depth 3, 24 steps, antithetic, the
    cross loss). Returns its facts."""
    import argparse
    import numpy as np
    from hairpt_torch.tools import inverse_furball

    args = argparse.Namespace(steps=24, res=256, fibers=6000, spp=2,
                              depth=3, sun_scale=3.0, no_antithetic=False,
                              log=None, device="cuda")
    t0 = time.time()
    r = inverse_furball.run(args)
    secs = time.time() - t0
    losses = r["losses"]
    tail = float(np.mean(losses[len(losses) * 2 // 3:]))
    log(f"inverse twin ({args.steps} steps, {secs:.1f}s): loss steps 0-2 "
        f"{losses[0]:.6f} {losses[1]:.6f} {losses[2]:.6f}, last-third "
        f"mean {tail:.6f}, last {losses[-1]:.6f}; recovered sigma_a "
        f"{r['sigma_a']} (true {r['sigma_a_true']}), beta_r "
        f"{r['beta_r']:.4f} (true {r['beta_r_true']:.4f})")
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(tail < losses[1], f"the twin's loss did not fall: step 1 "
            f"{losses[1]}, last third {tail}")
    return dict(secs=secs, losses=losses, sigma_a=r["sigma_a"],
                beta_r=r["beta_r"])


def _same_bits(x, y):
    """Equal dtype, shape and bits (a float NaN pattern, such as
    seg_rows_t's -1 ids, equals itself)."""
    import torch
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def _scene_tensors(a, path="arrays"):
    """(path, tensor) for every tensor of a scene's nested arrays."""
    import torch
    if torch.is_tensor(a):
        yield path, a
    elif hasattr(a, "_fields"):
        for f in a._fields:
            yield from _scene_tensors(getattr(a, f), f"{path}.{f}")


def xml_furball_builder(res=1024, device="cuda"):
    """Phase 11c's twin of the XML furball: the same scene through
    SceneBuilder with the parameters the loader reads (the XML's intIOR
    1.55 over the default extIOR "air" 1.000277, the sunsky at the
    loader's res 512, nee_rr 0, 1 spp)."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import emitters as em
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene import furball, hairgen
    from hairpt_torch.scene.scene import SceneBuilder

    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.ROUGHPLASTIC, twosided=False,
                       eta=1.55 / 1.000277, diffuse=furball.DIFFUSE,
                       alpha=0.2, dist=0)
    # the loader's stand-in rule (radius / sqrt(quality) below quality 1)
    radius = 0.00216667 / np.sqrt(min(max(HAIR_QUALITY, 1e-6), 1.0))
    b.add_fibers(hairgen.gen_furball(n_fibers=int(6000 * HAIR_QUALITY),
                                     radius=radius), m)
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, device=b.device)
    cam = Camera.perspective(furball.CAM_TO_WORLD, 35.0, res, res)
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, int(np.ceil(np.log2(res))), res))


def xml_render(scene, reset_all, deterministic=False):
    """One 1-spp wave (seed 0) with the kernel counts set to 0 just before
    it and read just after: (image, seconds, rays, A and B launches).
    deterministic: under torch.use_deterministic_algorithms (warn_only),
    which makes the film's index_add on the card sum in a fixed order."""
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk

    sync = torch.cuda.synchronize if img_device(scene) == "cuda" \
        else (lambda: None)
    reset_all()
    sync()
    t0 = time.time()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        img, st = path.render(scene, spp=1, seed=0, return_stats=True)
        sync()
    finally:
        torch.use_deterministic_algorithms(False)
    secs = time.time() - t0
    launches = dict(tk.LAUNCHES)
    off = dict(tk.OCT_LAUNCHES, **pk.LAUNCHES)
    plain = dict(tk.PLAIN_ON_CUDA)
    require(all(v == 0 for v in off.values()),
            f"an XML render ran an octet or swept kernel: {off}")
    require(all(v == 0 for v in plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    if img_device(scene) == "cuda":
        require(all(v > 0 for v in launches.values()),
                f"kernel A or B was not launched by an XML render: "
                f"{launches}")
    return img, secs, st["rays"], launches


def img_device(scene):
    return scene.arrays.hair.p0.device.type


def xml_entry_point(reset_all, phase4_mrays, res=1024, scale=0.5,
                    device="cuda"):
    """Phase 11: the scene-XML entry point. Writes the stand-in scene XMLs
    (hairpt_torch.scene.scene_xmls; the reference's XMLs are not in the
    repository) into a temporary directory, runs the CLI on the furball
    as a user would (1024^2, hair quality 14, depth 65, 2 spp, on the
    card), holds the loader to SceneBuilder array for array and image for
    image, and renders the four hair XMLs at `scale`. Returns A and B's
    launches on the XML furball's wave. (A small res and scale with
    device "cpu" rehearse it with the plain versions.)"""
    import re
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="hairpt_xml_") as tmp:
        xmls = {n: scene_xmls.write_scene(tmp, n) for n in scene_xmls.SCENES}
        xmls["furball"] = scene_xmls.write_scene(tmp, "furball", res=res)

        # b. the CLI as a user runs it
        out = os.path.join(tmp, "out", "furball.png")
        os.makedirs(os.path.dirname(out))
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "hairpt_torch.cli", "render",
             xmls["furball"], "-o", out, "--hair-quality",
             str(HAIR_QUALITY), "--spp", "2"]
            + (["--cpu"] if device == "cpu" else []),
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        require(proc.returncode == 0, f"the CLI exited {proc.returncode}:\n"
                f"{proc.stderr[-3000:]}")
        built = re.search(r"scene built in ([0-9.]+)s", proc.stderr)
        rendered = re.search(r"rendered in ([0-9.]+)s", proc.stderr)
        require(built is not None and rendered is not None,
                f"the CLI logged no build or render time:\n{proc.stderr}")
        base = out[:-4]
        for ext in ("png", "exr", "npy", "pfm"):
            require(os.path.getsize(f"{base}.{ext}") > 0, f"no {ext} output")
        img = np.load(f"{base}.npy")
        require(img.shape == (res, res, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"CLI image {img.shape}, mean "
                f"{img.mean()}")
        log(f"CLI furball ({res}^2, hair quality {HAIR_QUALITY}, depth 65, 2 "
            f"spp): exit 0 in {wall:.1f}s wall, scene built in "
            f"{built.group(1)}s, rendered in {rendered.group(1)}s; image "
            f"mean {img.mean():.6f}; four outputs")

        # c. the loader against SceneBuilder, on the card
        t0 = time.time()
        scene_x = load_scene(xmls["furball"], hair_quality=HAIR_QUALITY,
                             spp_override=1, device=device)
        t_load = time.time() - t0
        scene_b = xml_furball_builder(res, device)
        require(scene_x.config == scene_b.config,
                f"configs differ: {scene_x.config} {scene_b.config}")
        require(scene_x.film == scene_b.film
                and scene_x.active_kinds == scene_b.active_kinds
                and all(np.array_equal(a, b) for a, b in
                        zip(scene_x.camera, scene_b.camera)),
                "camera, film or kinds differ")
        pairs = list(zip(_scene_tensors(scene_x.arrays),
                         _scene_tensors(scene_b.arrays)))
        require(len(pairs) > 10 and all(
            pa == pb and _same_bits(x, y) for (pa, x), (pb, y) in pairs),
            "the XML scene's arrays differ from the builder's: "
            + str([pa for (pa, x), (pb, y) in pairs if not _same_bits(x, y)]))
        warm = xml_render(scene_x, reset_all)[1]
        img_x, secs_x, rays_x, launch_x = xml_render(scene_x, reset_all)
        img_b, _, _, launch_b = xml_render(scene_b, reset_all)
        require(launch_x == launch_b, f"launches differ: XML {launch_x}, "
                f"builder {launch_b}")
        # the film's index_add sums in the order the card's atomics land:
        # the images of one scene differ in the last bits from run to run,
        # so the equality is held with the film's sums in a fixed order
        diff = float((img_x - img_b).abs().max())
        img_x = xml_render(scene_x, reset_all, deterministic=True)[0]
        del scene_x
        img_b = xml_render(scene_b, reset_all, deterministic=True)[0]
        del scene_b
        require(torch.equal(img_x, img_b),
                "the XML furball's 1-spp image differs from the builder's "
                "with the film's sums in a fixed order")
        log(f"XML furball: loaded in {t_load:.1f}s, {len(pairs)} tensors "
            f"equal to SceneBuilder's; warm-up wave {warm:.2f}s, timed "
            f"1-spp wave {secs_x:.3f}s, {rays_x:.0f} rays, "
            f"{rays_x / secs_x / 1e6:.4f} Mrays/s (phase 4: "
            f"{phase4_mrays:.4f}); image torch.equal to the builder's "
            f"with the film's sums in a fixed order (largest |diff| "
            f"without: {diff:.3g}); launches {launch_x}")
        del img_x, img_b

        # d. the hair XMLs, in process
        for name in ("straight_marschner", "straight_kkay", "hair_curl",
                     "curly"):
            t0 = time.time()
            scene = load_scene(xmls[name], hair_quality=HAIR_QUALITY,
                               spp_override=1, res_scale=scale,
                               max_depth_override=65, device=device)
            t_load = time.time() - t0
            img, secs, rays, launches = xml_render(scene, reset_all)
            mean = float(img.mean())
            require(bool(torch.isfinite(img).all()) and mean > 0,
                    f"{name}: image mean {mean}")
            log(f"XML {name}: {scene.arrays.hair.p0.shape[0]} segments, "
                f"kinds {scene.active_kinds}, loaded in {t_load:.1f}s; "
                f"{tuple(img.shape)} 1-spp wave (no warm-up) {secs:.3f}s, "
                f"{rays:.0f} "
                f"rays, image mean {mean:.6f}; launches {launches}")
            del scene, img
    return launch_x

# kernel F (csrc/packed.cu): f32 operations per node visit (the slab test:
# per axis 2 subtractions, 2 products, a min and a max; 2 max and 2 min
# across the axes, 2 to widen, 3 compares) and per primitive test
# (Moller-Trumbore: 2 cross products, 4 dot products, the scaled u, v,
# t, the determinant's division and test, 8 compares, the lane's t < tb;
# the miter cylinder: the axis (its length, a square root and a
# division), 2 projections, the quadratic's a, b, t_mid, c_mid and
# discriminant, its root, both roots and both roots' miter planes),
# counted from the source, a division or square root counting one
F_SLAB_FLOPS = 27
F_TRI_FLOPS = 56
F_HAIR_FLOPS = 125
#  bytes: each input read once (the node rows, the leaf rows, 32 B per
#  ray of o, d, mint, maxt) and each output written once (8 B per ray of
#  t and pid, or 4 B of the flag); beside it, the traffic of the walk's
#  visits (32 B per node row, 256 B per leaf row read) at the same rate,
#  which the card's L2 serves in part (visit_bytes_ms)
F_NODE_BYTES = 32
F_LEAF_BYTES = 256
F_RAY_BYTES = 32
#  kernel F against its plain version: t and pid (closest) or the flag
#      (any) bit for bit (the same float32 operations in the same order
#      without fused multiply-adds, IEEE division and square root on both
#      sides, the first lane at the least t, a strict t < maxt across
#      leaves); its hair leaf against the tiled query (a different
#      cylinder arithmetic): hit flags equal, pid >= PID_MIN_AGREE, t
#      within T_RTOL
#  F's hair leaf against the tiled query, closest-hit flags: differing
#      on at most FLAG_MAX_DIFF of a wave's rays (the two cylinder
#      arithmetics disagree on a few grazes: 3 of the 1,048,576 camera
#      rays; a hit flag that no rounding explains would be a missed
#      fiber on far more rays)
FLAG_MAX_DIFF = 1e-5
#  graze_margin at or below GRAZE_TOL: a graze (float32 rounding of the
#      furball's coordinates, |o - p0| * 2^-23 ~ 1e-6, is ~5e-4 of its
#      0.00217 radius, and the margin is quadratic in the closest
#      approach)
GRAZE_TOL = 1e-2
F_REPLACES = {"closest": "hairpt/ops/intersect_packed.py:173",
              "any": "hairpt/ops/intersect_packed.py:228"}
TEAPOT_RES = (1280, 720)
# the CLIs of phases 12c-17b render at most CLI_WIDTH pixels across (the
# 1280 x 720 stand-ins at 512 x 288), 12c-16c at 1 spp
CLI_WIDTH = 512
# the hair quality of the CLIs of phases 14c-19f, which time no full-width
# furball (phase 11's CLI keeps the full furball: its wall time is the
# entry layer's metric); most of a CLI's wall at quality 14 was the
# 1,008,000-segment build
CLI_HAIR_QUALITY = 1.0
HEIGHTFIELD_G = 1025


def mesh_waves(scene, seed=11):
    """A camera wave (Sobol' sample 0, block-swizzled lanes, as render
    takes them) and a first-bounce wave (uniformly random directions in
    the hemisphere of the camera hit's normal, from the hit point lifted
    by ray_eps; missed lanes dead at the camera with maxt 0) of a scene,
    each as Ray, and the camera wave's hit fraction."""
    import numpy as np
    import torch
    from hairpt_torch.core import rng, warps
    from hairpt_torch.core.math import Ray
    from hairpt_torch.integrators import common
    from hairpt_torch.models import sensors

    cfg, arr = scene.config, scene.arrays
    dev = arr.device
    swz = common.block_swizzle(cfg.width, cfg.height)
    pixel = torch.as_tensor(swz, device=dev) if swz is not None \
        else torch.arange(cfg.width * cfg.height, device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jitter = smp.next_2d(0)
    pos = torch.stack([(smp.pixel % cfg.width).float() + jitter[:, 0],
                       (smp.pixel // cfg.width).float() + jitter[:, 1]], -1)
    cam_ray = sensors.sample_ray(scene.camera, pos)
    hit = common.scene_intersect(arr, cam_ray, cfg.tiled_q)
    n = pixel.shape[0]
    u = torch.as_tensor(np.random.default_rng(seed).random((n, 2)),
                        dtype=torch.float32, device=dev)
    d = warps.square_to_uniform_sphere(u)
    d = torch.where((torch.sum(d * hit.geo_n, -1) < 0)[:, None], -d, d)
    o = torch.where(hit.valid[:, None], hit.p + hit.geo_n * cfg.ray_eps,
                    cam_ray.o)
    bounce = Ray(o=o, d=d, mint=torch.zeros(n, device=dev),
                 maxt=torch.where(hit.valid, float("inf"), 0.0))
    return {"camera": cam_ray, "bounce": bounce}, \
        float(hit.valid.float().mean())


def f_bound(bvh, counts, n_rays, leaf, mode):
    """(bound ms, its kind, the visits' traffic in ms at the memory rate)
    of one walk: the inputs read once and the outputs written once
    against the operations of the plain walk's counted visits."""
    prim = F_TRI_FLOPS if leaf == "tri" else F_HAIR_FLOPS
    io = n_rays * (F_RAY_BYTES + (8 if mode == "closest" else 4))
    n_bytes = bvh.nodes.numel() * 4 + bvh.leaf_rows.numel() * 4 + io
    bms, bby = bound_ms(n_bytes, F_SLAB_FLOPS * counts["nodes"]
                        + prim * counts["prims"])
    visits = F_NODE_BYTES * counts["nodes"] \
        + F_LEAF_BYTES * counts["leaves"] + io
    return bms, bby, visits / HBM_BYTES_PER_S * 1e3


def _plain_fns():
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect as isec
    from hairpt_torch.ops import intersect_blocked as iblk
    from hairpt_torch.ops import intersect_packed as ipk
    return {"F_closest": ipk.closest_hit_packed_plain,
            "F_any": ipk.any_hit_packed_plain,
            "G_closest": gi.inst_closest_hit_plain,
            "G_any": gi.inst_any_hit_plain,
            "H_closest": isec.closest_hit_plain,
            "H_any": isec.any_hit_plain,
            "I_closest": iblk.closest_hit_blocked_plain,
            "I_any": iblk.any_hit_blocked_plain}


def run_plain(fn, args, kw, counts):
    """(result, counts, ms) of the plain walk `fn` (a key of _plain_fns),
    timed around a device synchronize."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    t0 = time.time()
    out = _plain_fns()[fn](*args, counts=counts, **kw)
    sync()
    return out, counts, (time.time() - t0) * 1e3


def plain_job(plain, fn, *args, counts=None, **kw):
    """The plain walk `fn` (a key of _plain_fns) on `args`: queued in
    `plain` (PlainWalks), or run now where `plain` is None. Returns the
    function that gives its (result, counts, ms)."""
    counts = counts if counts is not None else {}
    if plain is not None:
        return plain.call(fn, args, kw, counts)
    res = run_plain(fn, args, kw, counts)
    return lambda: res


class PlainWalks:
    """The host-bound plain walks of phases 12b, 13a and 14a, still on the
    card, in a subprocess (chip_smoke.py --plain-walks PATH) beside the
    main process's untimed card work, as the CPU references of phases 20
    and 21 run (cpu_refs). The checks time their kernels and queue their
    plain walks; start() saves every queued walk with its inputs in one
    file and starts the subprocess, which runs them in order and saves
    their results (each walk's output, counts and ms, timed there) in one
    file; a check's finish reads that file back. close() ends the
    subprocess and removes the files."""

    def __init__(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="hairpt_plain_")
        self.path = os.path.join(self.dir, "walks.pt")
        self.jobs, self.res, self.proc = [], None, None

    def call(self, fn, args, kw, counts):
        self.jobs.append((fn, args, kw, counts))
        i = len(self.jobs) - 1
        return lambda: self.result(i)

    def start(self):
        import torch
        torch.save(self.jobs, self.path)
        self.jobs = None
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--plain-walks",
             self.path], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=self.err)

    def result(self, i):
        import torch
        if self.res is None:
            try:
                rc = self.proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                rc = None
            self.err.seek(0)
            require(rc == 0, f"the plain walks' subprocess exited {rc}:\n"
                    f"{self.err.read()[-3000:]}")
            self.res = torch.load(self.path + ".res", weights_only=False)
        return self.res[i]

    def close(self):
        import shutil
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            self.err.close()
            self.proc = None
        shutil.rmtree(self.dir, ignore_errors=True)


def plain_walks_worker(path):
    """chip_smoke.py --plain-walks PATH: run the plain walks saved in PATH
    (PlainWalks.start) in order on the card and save their (result,
    counts, ms) to PATH.res."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jobs = torch.load(path, weights_only=False)
    torch.save([run_plain(*job) for job in jobs], path + ".res")
    return 0


def check_kernel_f(label, bvh, leaf, ray, report=None, share=1):
    """check_kernel_f_queued with its plain walks run now: {mode: (result
    on the whole wave, facts)}."""
    return check_kernel_f_queued(label, bvh, leaf, ray, report, share)[1]()


def check_kernel_f_queued(label, bvh, leaf, ray, report=None, share=1,
                          plain=None):
    """Phase 12a/b: kernel F against its plain version on EVERY ray of a
    wave (share > 1: on every share-th ray), closest and any
    hit (any on the same rays: the bounce wave's maxt is infinite where
    live), bit for bit; each timed (CUDA events, the wrapper's error-flag
    read included) beside its plain version and its bound from the
    walk's counted work (scaled to the whole wave). The kernels run and
    are timed now, the plain walks in `plain` (plain_job). Returns ({mode: result on the whole wave}, finish), finish() the
    comparison, returning {mode: (result, facts)}."""
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.ops import intersect_packed as ipk

    n = ray.o.shape[0]
    sl = _strided(n, share)
    sub = Ray(*[x[sl].contiguous() for x in ray])
    m = sub.o.shape[0]
    kern, pending = {}, []
    for mode in ("closest", "any"):
        kern_fn = ipk.closest_hit_packed if mode == "closest" \
            else ipk.any_hit_packed
        kern[mode] = kern_fn(bvh, leaf, ray)
        ms = cuda_ms(lambda: kern_fn(bvh, leaf, ray), 5)
        pending.append((mode, ms, plain_job(plain, f"F_{mode}", bvh, leaf,
                                            sub)))

    def finish():
        return _finish_f(label, bvh, leaf, report, share, n, m, sl, kern,
                         pending)
    return kern, finish


def _finish_f(label, bvh, leaf, report, share, n, m, sl, kern, pending):
    import torch
    out = {}
    for mode, ms, job in pending:
        p, counts, plain_ms = job()
        k_all = kern[mode]
        k = tuple(x[sl] for x in k_all) if mode == "closest" \
            else k_all[sl]
        if mode == "closest":
            same_t = torch.equal(k[0].view(torch.int32),
                                 p[0].view(torch.int32))
            same = same_t and torch.equal(k[1], p[1])
            n_hit = int((p[1] >= 0).sum())
            err = float((k[0] - p[0])[(p[1] >= 0) & (k[1] >= 0)].abs()
                        .max()) if n_hit else 0.0
            bad = int(((k[1] != p[1]) | (k[0].view(torch.int32)
                                         != p[0].view(torch.int32))).sum())
        else:
            same = torch.equal(k, p)
            n_hit = int(p.sum())
            err = 0.0
            bad = int((k != p).sum())
        bms, bby, vms = f_bound(bvh, _scaled(counts, n / m), n, leaf, mode)
        checked = "" if m == n else \
            f"; every {share}th ray against the plain version"
        log(f"F {leaf} {mode} on {label} ({n} rays{checked}, {n_hit} "
            f"hits): {'bit for bit' if same else f'{bad} rays DIFFER'}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on {m} rays "
            f"({counts['steps']} "
            f"iterations), bound {bms:.4f} ms by {bby} ({ms / bms:.1f}x; "
            f"{counts['nodes']} node rows, {counts['leaves']} leaf rows, "
            f"{counts['prims']} tests visited: {vms:.3f} ms of traffic)")
        require(same, f"kernel F ({leaf}, {mode}) differs from its plain "
                f"version on {bad} rays of {label}")
        out[mode] = (k_all, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=bby, visit_bytes_ms=vms,
                                 max_abs_err=err, rays=n, plain_rays=m,
                                 counts=counts))
        if report is not None:
            report.setdefault((leaf, mode), []).append((label, out[mode][1]))
    return out


def heightfield_scene(g=HEIGHTFIELD_G, device="cuda"):
    """The JAX loader's procedural heightfield ripples
    (hairpt/scene/xml_loader.py:777-782) at g x g (2 (g - 1)^2
    triangles), 40 x 40 under the teapot stand-in's camera, diffuse."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.core.math import matrix_lookat
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene.scene import SceneBuilder

    yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, g),
                         np.linspace(0, 4 * np.pi, g))
    mesh = shp.heightfield(0.1 * np.sin(xx) * np.cos(yy))
    b = SceneBuilder(device=device)
    m = b.add_material()
    to_world = np.array([[20.0, 0, 0, 0], [0, 0, 20.0, 0],
                         [0, -20.0, 0, 0], [0, 0, 0, 1]])
    b.add_mesh(mesh, m, to_world=to_world)
    w, h = TEAPOT_RES
    cam = Camera.perspective(matrix_lookat((0, 9, 22), (0, 2.5, 0),
                                           (0, 1, 0)), 40.0, w, h)
    return b.build(cam, Film.make(w, h, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, 11, w))


def teapot_kernels(report):
    """Phase 12a: kernel F's triangle leaf against its plain version on
    every ray of the teapot stand-in's camera and first-bounce waves
    (1280 x 720) and of the 2.1M-triangle heightfield's."""
    import tempfile
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    with tempfile.TemporaryDirectory(prefix="hairpt_teapot_") as tmp:
        scene = load_scene(scene_xmls.write_scene(tmp, "teapot"),
                           spp_override=1, device="cuda")
    arr = scene.arrays
    log(f"teapot stand-in: {arr.tri.p0.shape[0]} triangles, "
        f"{arr.tri_packed.nodes.shape[0]} nodes, {scene.config.width} x "
        f"{scene.config.height}")
    wv, frac = mesh_waves(scene)
    log(f"teapot camera wave hit fraction {frac:.4f}")
    for name, ray in wv.items():
        check_kernel_f(f"the teapot's {name} wave", arr.tri_packed, "tri",
                       ray, report)
    del scene, wv
    t0 = time.time()
    hf = heightfield_scene()
    log(f"heightfield {HEIGHTFIELD_G}^2: {hf.arrays.tri.p0.shape[0]} "
        f"triangles, {hf.arrays.tri_packed.nodes.shape[0]} nodes, built in "
        f"{time.time() - t0:.1f}s")
    wv, frac = mesh_waves(hf)
    log(f"heightfield camera wave hit fraction {frac:.4f}")
    for name, ray in wv.items():
        check_kernel_f(f"the heightfield's {name} wave", hf.arrays.tri_packed,
                       "tri", ray, report)


def graze_margin(hair, pid, o, d, t):
    """float64: how far the ray (o, d) is from the boundary of the miter
    cylinder `pid` of `hair` (HairGeom) at the root nearest t, relative
    to the radius: the least of 1 - (closest approach / r)^2 and the two
    miter planes' distances / r. Near 0: a graze, where two float32
    cylinder arithmetics may disagree on a hit."""
    import numpy as np
    g = [np.asarray(x[pid].double().cpu()) for x in
         (hair.p0, hair.p1, hair.n0, hair.n1, hair.radius)]
    p0, p1, n0, n1, r = g
    o = np.asarray(o.double().cpu())
    d = np.asarray(d.double().cpu())
    ax = (p1 - p0) / np.linalg.norm(p1 - p0)
    rel = o - p0
    po, pd = rel - (ax @ rel) * ax, d - (ax @ d) * ax
    a = pd @ pd
    t_mid = -(po @ pd) / a
    q = po + pd * t_mid
    closest = 1.0 - (q @ q) / (r * r)
    dt = np.sqrt(max(closest * r * r / a, 0.0))
    tt = min((t_mid - dt, t_mid + dt), key=lambda x: abs(x - float(t)))
    h = o + d * tt
    return float(min(abs(closest), abs((h - p0) @ n0) / r,
                     abs((h - p1) @ n1) / r))


def outside_box(hair, pid, o, d, t):
    """float64: how far the point o + d t lies outside the box that the
    hair BVH gives segment `pid` (the JAX package's conservative AABB,
    hairpt/scene/scene.py:500-508: the radius over the steeper miter's
    |cos|, that cos clamped at 0.3), in units of the radius. Above 0, the
    packed walk cannot reach a hit there, in either package."""
    import numpy as np
    p0, p1, n0, n1, r = [np.asarray(x[pid].double().cpu()) for x in
                         (hair.p0, hair.p1, hair.n0, hair.n1, hair.radius)]
    tang = (p1 - p0) / np.linalg.norm(p1 - p0)
    cos = min(abs(n0 @ tang), abs(n1 @ tang))
    expand = r / max(cos, 0.3)
    h = np.asarray(o.double().cpu()) + np.asarray(d.double().cpu()) * t
    out = np.maximum(np.minimum(p0, p1) - expand - h, 0.0) \
        + np.maximum(h - np.maximum(p0, p1) - expand, 0.0)
    return float(np.max(out) / r)


def furball_kernel_f(scene, wv, report, plain=None):
    """Phase 12b: kernel F's hair leaf on the full-width furball's camera
    and first-bounce waves: against its plain version bit for bit (the
    plain walks in `plain`; returns the function that finishes those
    checks), and
    against the tiled query (kernels A and B, another float32 cylinder
    arithmetic): pid >= PID_MIN_AGREE; closest-hit flags differing on at
    most FLAG_MAX_DIFF of the rays; where the pids agree, t within T_RTOL
    on >= PID_MIN_AGREE of the hits, a graze of that cylinder
    (graze_margin <= GRAZE_TOL, where t is ill-conditioned) counting as
    agreeing; each query's any-hit flags equal to its own closest-hit
    flags (maxt is infinite or 0). The rays whose pids differ are logged
    as ties (t within T_RTOL), grazes of the nearer hit's cylinder, and
    the rest; the same-pid rays whose t is off, with their t, difference
    and margin."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled

    arr = scene.arrays
    finishes = []
    for name, ray in wv.items():
        res, finish = check_kernel_f_queued(
            f"the furball's {name} wave", arr.hair_packed, "hair", ray,
            report, F_HAIR_PLAIN_SHARE, plain)
        finishes.append(finish)
        t_f, p_f = res["closest"]
        t_q, p_q = itiled.tiled_closest_hit(arr.hair_swept, ray, q_max=2048)
        occ_q = itiled.tiled_any_hit(arr.hair_swept, ray, q_max=2048)
        n = p_f.shape[0]
        same = p_f == p_q
        agree = float(same.float().mean())
        flags = int(((p_f >= 0) != (p_q >= 0)).sum())
        own = int((res["any"] != (p_f >= 0)).sum()) \
            + int((occ_q != (p_q >= 0)).sum())
        rel = (t_f - t_q).abs() / t_q.abs().clamp(min=1e-30)
        n_same = int((same & (p_f >= 0)).sum())
        off = torch.nonzero(same & (p_f >= 0) & (rel > T_RTOL))[:, 0]
        t_bad = []
        for i in off.tolist():
            m = graze_margin(arr.hair, int(p_f[i]), ray.o[i], ray.d[i],
                             float(t_q[i]))
            if m > GRAZE_TOL:
                t_bad.append((float(rel[i]), float(t_q[i]),
                              float(t_f[i] - t_q[i]), m))
        t_bad.sort(reverse=True)
        ties, grazes, boxed, other, worst = 0, 0, 0, 0, 0.0
        for i in torch.nonzero(~same)[:, 0].tolist():
            tf_, tq_ = float(t_f[i]), float(t_q[i])
            if p_f[i] >= 0 and p_q[i] >= 0 \
                    and abs(tf_ - tq_) <= T_RTOL * abs(tq_):
                ties += 1
                continue
            near = int(p_f[i]) if tf_ <= tq_ else int(p_q[i])
            m = graze_margin(arr.hair, near, ray.o[i], ray.d[i],
                             min(tf_, tq_))
            worst = max(worst, m)
            if m <= GRAZE_TOL:
                grazes += 1
            elif tq_ < tf_ and outside_box(arr.hair, near, ray.o[i],
                                           ray.d[i], tq_) > 0:
                boxed += 1
            else:
                other += 1
        log(f"F hair on the furball's {name} wave against the tiled query: "
            f"pid agreement {agree:.6f} ({int((~same).sum())} rays differ: "
            f"{ties} ties, {grazes} grazes, {boxed} tiled hits outside the "
            f"hair BVH's box, {other} others; largest margin {worst:.3g}); "
            f"{flags} closest-hit flags differ; "
            f"of {n_same} same-pid hits {off.numel()} with t past T_RTOL, "
            f"{len(t_bad)} of them not at a graze (the worst: rel, t, "
            f"diff, margin {[tuple(f'{x:.3g}' for x in b) for b in t_bad[:4]]}"
            f"); any-hit flags off their closest-hit flags: {own}")
        require(agree >= PID_MIN_AGREE and flags <= FLAG_MAX_DIFF * n
                and len(t_bad) <= (1.0 - PID_MIN_AGREE) * n_same
                and own == 0,
                f"F's hair leaf disagrees with the tiled query on the "
                f"{name} wave: pid {agree}, {flags} flags, {len(t_bad)} t "
                f"off a graze, any-hit {own}")
    return lambda: [f() for f in finishes]


def teapot_entry_point(reset_all, device="cuda", res_scale=1.0,
                       between=None):
    """Phase 12c: the CLI on the teapot stand-in as a user runs it
    (CLI_WIDTH across, depth 65, 1 spp; beside between(), the CPU-bound
    phase 12d, when given), then one warm-up wave and two timed 1-spp
    waves in process at 1280 x 720. Returns (s/wave, rays/wave, F's
    launches over the timed waves, their number)."""
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    with tempfile.TemporaryDirectory(prefix="hairpt_teapot_") as tmp:
        xml = scene_xmls.write_scene(tmp, "teapot")
        cli_scale = res_scale * CLI_WIDTH / TEAPOT_RES[0]
        cli_h = _cli_start(xml, os.path.join(tmp, "out", "teapot.png"), 1.0,
                           device, spp=1, res_scale=cli_scale)
        if between is not None:
            between()
        wall, _, _, img = _cli_wait(cli_h)
        w, h = (max(8, round(x * cli_scale)) for x in TEAPOT_RES)
        require(img.shape == (h, w, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"teapot CLI image {img.shape}, mean "
                f"{img.mean()}")
        log(f"CLI teapot ({w} x {h}, depth 65, 1 spp): exit 0 in {wall:.1f}s "
            f"wall{' beside phase 12d' if between else ''}; image mean "
            f"{img.mean():.6f}; four outputs")
        w, h = (max(8, round(x * res_scale)) for x in TEAPOT_RES)
        scene = load_scene(xml, spp_override=1, res_scale=res_scale,
                           device=device)
    if device != "cuda":
        return None
    progress, times, rays, n_timed = warm_up(scene, "teapot")
    reset_all()
    torch.cuda.synchronize()
    img = path.render(scene, spp=n_timed, seed=1, progress=progress)
    torch.cuda.synchronize()
    launches = dict(ipk.LAUNCHES)
    plain = dict(ipk.PLAIN_ON_CUDA)
    hair = dict(tk.LAUNCHES)
    secs = sum(times) / len(times)
    rays_w = sum(rays) / len(rays)
    log(f"teapot render: {n_timed} timed waves of 1 spp at {w} x {h}, depth "
        f"65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
        f"{rays_w / secs / 1e6:.4f} Mrays/s; image mean "
        f"{float(img.mean()):.6f}; F launches {launches} "
        f"({launches['packed_tri_closest'] / n_timed:.1f} closest and "
        f"{launches['packed_tri_any'] / n_timed:.1f} any per wave)")
    require(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
            "teapot render: non-finite or black")
    require(launches["packed_tri_closest"] > 0
            and launches["packed_tri_any"] > 0,
            f"kernel F was not launched by the teapot render: {launches}")
    require(all(v == 0 for v in plain.values()),
            f"plain walks ran on CUDA tensors: {plain}")
    require(all(v == 0 for v in hair.values()),
            f"the teapot render ran a hair kernel: {hair}")
    return secs, rays_w, launches, n_timed


def furball_floor(reset_all):
    """Phase 12d: the small furball over the checkerboard rectangle on the
    card and with the plain versions on the CPU, tiled and packed: image
    means within MEAN_RTOL; on the card the tiled render launches A, B
    and F's triangle leaf, the packed render F's hair and triangle
    leaves. Returns the packed render's F launches."""
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene.furball import furball_floor_scene

    out = None
    for trav in ("tiled", "packed"):
        means = {}
        for dev in ("cuda", "cpu"):
            s = furball_floor_scene(quality=0.1, res=64, depth=8,
                                    device=dev, traversal=trav)
            reset_all()
            means[dev] = float(path.render(s, spp=1).mean())
            if dev == "cuda":
                f_l = dict(ipk.LAUNCHES)
                ab = dict(tk.LAUNCHES)
                plain = dict(ipk.PLAIN_ON_CUDA, **tk.PLAIN_ON_CUDA)
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"furball over the checkerboard, {trav} (600 fibers, 64^2, "
            f"depth 8): image mean card {means['cuda']:.6f}, CPU "
            f"{means['cpu']:.6f}, rel diff {rel:.3g}; card launches: F "
            f"{f_l}, A and B {ab}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"furball over the floor ({trav}): card and CPU means "
                f"differ by {rel}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
        need = ["packed_tri_closest", "packed_tri_any"]
        if trav == "tiled":
            require(all(v > 0 for v in ab.values()), f"A or B was not "
                    f"launched by the tiled floor render: {ab}")
        else:
            need += ["packed_hair_closest", "packed_hair_any"]
            require(all(v == 0 for v in ab.values()), f"the packed floor "
                    f"render ran A or B: {ab}")
            out = f_l
        require(all(f_l[k] > 0 for k in need),
                f"kernel F was not launched by the {trav} floor render: "
                f"{f_l}")
    return out


def f_kernel_entries(report, tri_launches, hair_launches, n_timed):
    """The kernels line's entries for kernel F: one per instance, its time
    on the first wave checked (the teapot's and the furball's camera
    waves), its launches on the main path (the teapot's timed waves for
    the triangle leaf, the packed floor render for the hair leaf)."""
    entries = []
    for (leaf, mode), rows in sorted(report.items()):
        label, f = rows[0]
        name = f"packed_{leaf}_{mode}"
        tri = leaf == "tri"
        entries.append(dict(
            name=name, route="cuda", source="hairpt_torch/csrc/packed.cu",
            replaces=F_REPLACES[mode],
            launches=(tri_launches if tri else hair_launches)[name],
            max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None,
            visit_bytes_ms=f["visit_bytes_ms"], rays=f["rays"],
            plain_rays=f["plain_rays"], timed_on=label,
            launched_by=("the teapot's timed waves (phase 12c)" if tri else
                         "the packed floor render (phase 12d)"),
            launches_per_wave=((tri_launches[name] / n_timed) if tri
                               else None),
            other_waves={lb: dict(ms=x["ms"], plain_ms=x["plain_ms"],
                                  bound_ms=x["bound_ms"],
                                  visit_bytes_ms=x["visit_bytes_ms"])
                         for lb, x in rows[1:]}))
    return entries


# kernel G (csrc/instanced.cu): f32 operations per instance box test (the
# slab test of packed_walk.cuh's walk, 27, plus the closest hit's
# min(maxt, best t) and the cull decision, counted from the source as
# 30) and per ray transform (o': 3 rows of 3 products and 3 sums; d': 3
# of 3 products and 2 sums, 33), and F's counts per node row and
# triangle test; bytes: the instance table, every prototype's node and
# leaf rows, 32 B per ray and the outputs (12 B per ray closest, 4 B any)
G_BOX_FLOPS = 30
G_XFORM_FLOPS = 33
G_REPLACES = {"closest": "hairpt/ops/instancing.py:173",
              "any": "hairpt/ops/instancing.py:195"}
#  13b, card against CPU: image means within MEAN_RTOL (phase 3's rule)
INST_SMALL = dict(res_scale=0.075, max_depth_override=5)


def g_bound(inst, counts, n_rays, mode):
    """(bound ms, its kind) of one two-level walk of a wave: the inputs
    read once and the outputs written once against the operations of
    the plain version's counted work."""
    io = n_rays * (F_RAY_BYTES + (12 if mode == "closest" else 4))
    n_bytes = (inst.table.numel() + inst.nodes.numel()
               + inst.leaf_rows.numel()) * 4 + io
    return bound_ms(n_bytes, G_BOX_FLOPS * counts["boxes"]
                    + G_XFORM_FLOPS * counts["walked"]
                    + F_SLAB_FLOPS * counts["nodes"]
                    + F_TRI_FLOPS * counts["prims"])


def per_instance_f(inst, ray, mode):
    """The JAX package's structure carried over to the card (a yardstick
    of kernel G, never on the port's path): per instance in order the
    world box test and the object ray as plain tensor ops, then one launch
    of kernel F on the prototype's tree."""
    import torch
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops.tiled_kernels import _inv_dir
    n = ray.o.shape[0]
    inv_d = _inv_dir(ray.d)
    best_t = torch.full((n,), float("inf"), device=ray.o.device)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=ray.o.device)
    best_i = best_p.clone()
    occ = torch.zeros((n,), dtype=torch.bool, device=ray.o.device)
    for i, p in enumerate(inst.proto_ids):
        mt = ray.maxt if mode == "any" else torch.minimum(ray.maxt, best_t)
        box = gi._aabb_cull(ray.o, inv_d, ray.mint, mt, inst.aabb_lo[i],
                            inst.aabb_hi[i])
        o2, d2 = gi.obj_ray_arrays(ray.o, ray.d, inst.w2o[i])
        sub = ray._replace(o=o2, d=d2, maxt=torch.where(
            box & ~occ if mode == "any" else box, mt, 0.0))
        if mode == "any":
            occ = occ | ipk.any_hit_packed(inst.proto_bvh(p), "tri", sub)
        else:
            t, prim = ipk.closest_hit_packed(inst.proto_bvh(p), "tri", sub)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_p = torch.where(better, prim, best_p)
            best_i = torch.where(better, i, best_i)
    return occ if mode == "any" else (best_t, best_p, best_i)


def flattened_f(scene):
    """The stand-in's instances flattened into one mesh (a yardstick of
    kernel G): the prototype under each instance's to_world, one packed
    BVH on the card. Returns (PackedBVH, its triangle count)."""
    import numpy as np
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.ops import bvh as bvh_mod
    from hairpt_torch.ops import intersect_packed as ipk
    a = scene.arrays.inst
    nb, m, lb, nl, pb, nt = a.protos[0][:6]
    p0 = a.p0[pb:pb + nt].double().cpu().numpy()
    pos = np.concatenate([p0, p0 + a.e1[pb:pb + nt].double().cpu().numpy(),
                          p0 + a.e2[pb:pb + nt].double().cpu().numpy()])
    faces = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    mesh = shp.Mesh(pos, None, None, faces)
    w2o = a.w2o.double().cpu().numpy()
    meshes = []
    for i in range(len(a.proto_ids)):
        m4 = np.eye(4)
        m4[:3] = w2o[i]
        meshes.append(shp.transform_mesh(mesh, np.linalg.inv(m4)))
    flat = shp.merge(meshes)
    f = flat.faces
    v = np.asarray(flat.positions, np.float32)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fb = bvh_mod.build(np.minimum(np.minimum(v0, v1), v2),
                       np.maximum(np.maximum(v0, v1), v2))
    o = fb.prim_order
    rows = ipk.tri_pack_rows(v0[o], v1[o], v2[o], o)
    return ipk.pack_bvh(fb, rows, device="cuda"), len(f)


def _strided(n, share):
    """Every share-th of n lanes, from the first, as a slice: an even
    sample of a wave in its ray order, so that the plain version's counted
    work, times share, estimates the whole wave's."""
    return slice(0, n, share)


def _scaled(counts, factor):
    return {k: v * factor for k, v in counts.items()}


def instanced_kernels(report, plain=None):
    """Phase 13a: kernel G against its plain version on every
    G_PLAIN_SHARE-th ray of the instanced stand-in's camera and
    first-bounce waves (1280 x 720, 64 instances), closest and any hit,
    t, prim, which and occ bit for bit; each timed beside its plain
    version (one call on those rays), its bound (the plain version's
    counted work scaled to the whole wave) and two yardsticks: the JAX
    structure carried over (per_instance_f, which must equal the plain
    version on the same rays) and the instances flattened into one mesh
    walked by F (flattened_f). The kernels and yardsticks run and are
    timed now, the plain walks in `plain`; returns the function that
    finishes the checks."""
    import tempfile
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="hairpt_inst_") as tmp:
        scene = load_scene(scene_xmls.write_scene(tmp, "instanced"),
                           spp_override=1, device="cuda")
    a = scene.arrays.inst
    log(f"instanced stand-in: {len(a.proto_ids)} instances of "
        f"{a.p0.shape[0]} triangles ({a.nodes.shape[0]} nodes), "
        f"{scene.arrays.tri.p0.shape[0]} other triangles, "
        f"{scene.config.width} x {scene.config.height}, built in "
        f"{time.time() - t0:.1f}s")
    wv, frac = mesh_waves(scene)
    t1 = time.time()
    flat, n_flat = flattened_f(scene)
    log(f"instanced camera wave hit fraction {frac:.4f}; flattened "
        f"yardstick: {n_flat} triangles, built in {time.time() - t1:.1f}s")
    pending = []
    for name, ray in wv.items():
        n = ray.o.shape[0]
        sl = _strided(n, G_PLAIN_SHARE)
        sub = Ray(*[x[sl].contiguous() for x in ray])
        m = sub.o.shape[0]
        for mode in ("closest", "any"):
            closest = mode == "closest"
            kern = gi.inst_closest_hit if closest else gi.inst_any_hit
            k_all = kern(a, ray)
            y = per_instance_f(a, sub, mode)
            ms = cuda_ms(lambda: kern(a, ray), 5)
            y_ms = cuda_ms(lambda: per_instance_f(a, ray, mode), 2)
            f_fn = ipk.closest_hit_packed if closest else ipk.any_hit_packed
            f_ms = cuda_ms(lambda: f_fn(flat, "tri", ray), 5)
            fk = f_fn(flat, "tri", ray)
            f_same = float(((fk[1] >= 0) == (k_all[1] >= 0)).float()
                           .mean()) if closest \
                else float((fk == k_all).float().mean())
            k = tuple(x[sl] for x in k_all) if closest else k_all[sl]
            pending.append((name, mode, n, m, k, y, ms, y_ms, f_ms, f_same,
                            plain_job(plain, f"G_{mode}", a, sub)))
    del scene, wv, flat

    def finish():
        for name, mode, n, m, k, y, ms, y_ms, f_ms, f_same, job in pending:
            p, counts, plain_ms = job()
            if mode == "closest":
                bad = int(((k[0].view(torch.int32) != p[0].view(torch.int32))
                           | (k[1] != p[1]) | (k[2] != p[2])).sum())
                bad_y = int(((y[0].view(torch.int32)
                              != p[0].view(torch.int32)) | (y[1] != p[1])
                             | (y[2] != p[2])).sum())
                n_hit = int((p[1] >= 0).sum())
            else:
                bad, bad_y, n_hit = int((k != p).sum()), \
                    int((y != p).sum()), int(p.sum())
            bms, bby = g_bound(a, _scaled(counts, n / m), n, mode)
            log(f"G {mode} on the instanced {name} wave ({n} rays; every "
                f"{G_PLAIN_SHARE}th ray, {m} rays and {n_hit} hits, "
                f"against the plain version): "
                f"{'bit for bit' if bad == 0 else f'{bad} rays DIFFER'}"
                f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on the "
                f"checked rays, bound "
                f"{bms:.4f} ms by {bby} ({ms / bms:.1f}x; {counts['boxes']} "
                f"box tests, {counts['walked']} walks, {counts['nodes']} node "
                f"rows, {counts['prims']} tests); the JAX structure (64 F "
                f"launches) {y_ms:.3f} ms ({bad_y} rays off the plain "
                f"version), the flattened mesh through F {f_ms:.3f} ms (hit "
                f"flags equal on {f_same:.6f})")
            require(bad == 0, f"kernel G ({mode}) differs from its plain "
                    f"version on {bad} rays of the {name} wave")
            report.setdefault(mode, []).append((name, dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                max_abs_err=0.0, per_instance_f_ms=y_ms,
                flattened_f_ms=f_ms, rays=n, plain_rays=m,
                counts=counts)))
    return finish


def instanced_small(reset_all):
    """Phase 13b: the stand-in at INST_SMALL on the card and with the
    plain versions on the CPU: image means within MEAN_RTOL; the card
    render launches G and F and runs no plain version on CUDA tensors."""
    import tempfile
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    means = {}
    with tempfile.TemporaryDirectory(prefix="hairpt_inst_") as tmp:
        xml = scene_xmls.write_scene(tmp, "instanced")
        for dev in ("cuda", "cpu"):
            s = load_scene(xml, spp_override=1, device=dev, **INST_SMALL)
            reset_all()
            t0 = time.time()
            means[dev] = float(path.render(s, spp=1).mean())
            secs = time.time() - t0
            if dev == "cuda":
                g_l, f_l = dict(gi.LAUNCHES), dict(ipk.LAUNCHES)
                plain = dict(gi.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
            log(f"instanced small ({s.config.width} x {s.config.height}, "
                f"depth {s.config.max_depth}) on {dev}: {secs:.1f}s, image "
                f"mean {means[dev]:.6f}")
    rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]), 1e-12)
    log(f"instanced small: card against CPU rel diff {rel:.3g}; card "
        f"launches G {g_l}, F {f_l}")
    require(means["cpu"] > 0 and rel <= MEAN_RTOL,
            f"instanced small: card and CPU means differ by {rel}")
    require(all(v > 0 for v in g_l.values()), f"kernel G was not launched "
            f"by the small instanced render: {g_l}")
    require(all(v == 0 for v in plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")


def instanced_entry_point(reset_all, device="cuda", res_scale=1.0,
                          between=None):
    """Phase 13c: the CLI as a subprocess at CLI_WIDTH across and 1 spp
    (wall time, its logged build and render seconds; beside between(),
    the CPU-bound phase 13b, when given), then the stand-in at full width
    (1280 x 720, depth 65): one warm-up wave and two timed 1-spp waves in
    process (s/wave, Mrays/s, G's and F's launches per wave). Returns
    (s/wave, rays/wave, G's launches, F's launches, waves timed)."""
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    with tempfile.TemporaryDirectory(prefix="hairpt_inst_") as tmp:
        xml = scene_xmls.write_scene(tmp, "instanced")
        cli_scale = res_scale * CLI_WIDTH / TEAPOT_RES[0]
        cli_h = _cli_start(xml, os.path.join(tmp, "out", "instanced.png"),
                           1.0, device, spp=1, res_scale=cli_scale)
        if between is not None:
            between()
        wall, t_build, t_render, img = _cli_wait(cli_h)
        w, h = (max(8, round(x * cli_scale)) for x in TEAPOT_RES)
        require(img.shape == (h, w, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"instanced CLI image {img.shape}, mean "
                f"{img.mean()}")
        log(f"CLI instanced ({w} x {h}, depth 65, 1 spp): exit 0 in "
            f"{wall:.1f}s wall{' beside phase 13b' if between else ''}, "
            f"scene built in {t_build}s, rendered in {t_render}s; image "
            f"mean {img.mean():.6f}; four outputs")
        t0 = time.time()
        scene = load_scene(xml, spp_override=1, res_scale=res_scale,
                           device=device)
        log(f"instanced stand-in loaded in {time.time() - t0:.1f}s")
        if device == "cuda":
            progress, times, rays, n_timed = warm_up(scene, "instanced")
            reset_all()
            torch.cuda.synchronize()
            img = path.render(scene, spp=n_timed, seed=1, progress=progress)
            torch.cuda.synchronize()
            g_l, f_l = dict(gi.LAUNCHES), dict(ipk.LAUNCHES)
            plain = dict(gi.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
            hair = dict(tk.LAUNCHES)
            secs = sum(times) / len(times)
            rays_w = sum(rays) / len(rays)
            log(f"instanced render: {n_timed} timed waves of 1 spp at "
                f"{scene.config.width} x {scene.config.height}, depth 65: "
                f"{rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
                f"{rays_w / secs / 1e6:.4f} Mrays/s; image mean "
                f"{float(img.mean()):.6f}; G launches {g_l} "
                f"({g_l['inst_closest'] / n_timed:.1f} closest and "
                f"{g_l['inst_any'] / n_timed:.1f} any per wave), F "
                f"{f_l['packed_tri_closest'] / n_timed:.1f} closest and "
                f"{f_l['packed_tri_any'] / n_timed:.1f} any per wave")
            require(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                    "instanced render: non-finite or black")
            require(all(v > 0 for v in g_l.values())
                    and f_l["packed_tri_closest"] > 0
                    and f_l["packed_tri_any"] > 0,
                    f"G or F was not launched by the instanced render: G "
                    f"{g_l}, F {f_l}")
            require(all(v == 0 for v in plain.values()),
                    f"plain versions ran on CUDA tensors: {plain}")
            require(all(v == 0 for v in hair.values()),
                    f"the instanced render ran a hair kernel: {hair}")
            del img
        del scene
    if device != "cuda":
        return None
    return secs, rays_w, g_l, f_l, n_timed


def g_kernel_entries(report, launches, n_timed):
    """The kernels line's entries for kernel G: its time on the camera
    wave, its launches over phase 13c's timed waves."""
    entries = []
    for mode in ("closest", "any"):
        (label, f), *rest = report[mode]
        name = f"inst_{mode}"
        entries.append(dict(
            name=name, route="cuda", source="hairpt_torch/csrc/instanced.cu",
            replaces=G_REPLACES[mode], launches=launches[name],
            max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None,
            per_instance_f_ms=f["per_instance_f_ms"],
            flattened_f_ms=f["flattened_f_ms"],
            plain_rays=f["plain_rays"], rays=f["rays"],
            timed_on=f"the instanced {label} wave (plain_ms on plain_rays "
            f"of its rays)",
            launched_by="the instanced stand-in's timed waves (phase 13c)",
            launches_per_wave=launches[name] / n_timed,
            other_waves={lb: {k: x[k] for k in (
                "ms", "plain_ms", "bound_ms", "per_instance_f_ms",
                "flattened_f_ms")} for lb, x in rest}))
    return entries


# kernels H and I (csrc/perray.cu, csrc/blocked.cu): bytes read once (the
# BVHArrays: 24 B of box and 12 B of left, count and skip per node; the
# sorted geometry, 36 B per triangle, 52 B per hair segment; 32 B per ray)
# and written once (8 B per ray closest, 4 B any), against the operations
# of the per-ray walk's counted visits (F_SLAB_FLOPS per node row,
# F_TRI_FLOPS / F_HAIR_FLOPS per primitive test): the least work of the
# function both walks compute, so H's and I's rows share one bound per
# wave and mode (I's own work, a block's union of nodes for every lane,
# is logged beside it as work_ms)
H_NODE_BYTES = 36
H_PRIM_BYTES = {"tri": 36, "hair": 52}
H_REPLACES = {"closest": "hairpt/ops/intersect.py:143",
              "any": "hairpt/ops/intersect.py:189"}
I_REPLACES = {"closest": "hairpt/ops/intersect_blocked.py:111",
              "any": "hairpt/ops/intersect_blocked.py:176"}
#  kernels H and I against their plain versions: t and pid (closest) or
#      the flag (any) bit for bit (the same float32 operations as kernel
#      F's, in the same order, without fused multiply-adds); I's plain
#      version on every I_FURBALL_STRIDE-th block of the furball's camera
#      wave (blocks are independent; 61 is prime to the 32 blocks of a
#      row of 8 x 8 tiles, so the blocks checked spread over the image)
#      and on every block of the teapot's waves. The plain loop runs one
#      iteration per node of the longest block's walk, about 1.7 ms on
#      the card: a block of the furball's first-bounce wave (256 random
#      directions) walks some 125,000 nodes, minutes per block, so on
#      that wave I is held to H on every ray (PERF.md, PR 15: its plain
#      check on 64 blocks, bit for bit, took 258 s)
I_FURBALL_STRIDE = 61
# the plain versions of G (phase 13a) and of F's and H's hair leaf (12b,
# 14a) run on every share-th ray of each wave (every ray took 50, 21 and
# 19 s); the kernels run on the whole wave, and their bounds scale the
# plain version's counted work on that even sample to it
G_PLAIN_SHARE = 8
F_HAIR_PLAIN_SHARE = 4
# kernel E's plain version on every share-th of each wave's live chunks,
# and the dead tail (phase 2c)
E_PLAIN_SHARE = 4
I_BLOCK = 256
#  H against F on the same tree and the same float32 primitives (F's
#      packed rows, gathered into sorted order): bit for bit, the any hit
#      where maxt > mint (F counts maxt <= mint as no hit, the JAX
#      package's per-ray walk does not)
#  I against H on every ray: equal, or differing on at most IH_MAX_DIFF
#      of the rays, each logged (a hair hit outside its segment's box,
#      chip_smoke.outside_box, is reached by a block whose other lanes
#      enter the ancestors' boxes, never by the per-ray walk)
IH_MAX_DIFF = 1e-5
#  14b, card against CPU: image means within MEAN_RTOL (phase 3's rule)
MOTION_SMALL = dict(res=32, depth=4, spp=2)
MOTION_SMALL_QUALITY = 0.02


def h_bound(bvh, geom, leaf, counts, n_rays, mode):
    """(bound ms, its kind) of one walk of a wave over the BVHArrays: the
    inputs read once and the outputs written once against the per-ray
    walk's counted operations."""
    prim = F_TRI_FLOPS if leaf == "tri" else F_HAIR_FLOPS
    io = n_rays * (F_RAY_BYTES + (8 if mode == "closest" else 4))
    n_bytes = bvh.node_left.numel() * H_NODE_BYTES \
        + geom.p0.shape[0] * H_PRIM_BYTES[leaf] + io
    return bound_ms(n_bytes, F_SLAB_FLOPS * counts["nodes"]
                    + prim * counts["prims"])


def rows_geom(packed, leaf):
    """The packed BVH's primitives (kernel F's float32 values) in sorted
    order, as the TriGeom or HairGeom kernel H reads."""
    import torch
    from hairpt_torch.scene.scene import HairGeom, TriGeom
    rows = packed.leaf_rows.view(-1, 16)
    pid = rows[:, 15].contiguous().view(torch.int32)
    keep = pid >= 0
    out = torch.zeros((int(pid.max()) + 1, 16), device=rows.device)
    out[pid[keep].long()] = rows[keep]
    if leaf == "tri":
        return TriGeom(*[out[:, a:a + 3].contiguous() for a in (0, 3, 6)])
    return HairGeom(*[out[:, a:a + 3].contiguous() for a in (0, 3, 6, 9)],
                    radius=out[:, 12].contiguous())


def _differ(a, b, closest):
    """Rays where two results differ (closest: pid or the bits of t)."""
    import torch
    if not closest:
        return a != b
    return (a[1] != b[1]) | (a[0].view(torch.int32) != b[0].view(torch.int32))


def check_kernel_h(label, bvh, geom, packed, leaf, ray, report, share=1,
                   plain=None):
    """Phase 14a: kernel H against its plain version on EVERY ray of a
    wave (share > 1: on every share-th ray), closest and any
    hit, bit for bit, and against kernel F on the same tree and
    primitives on every ray; timed (CUDA events) beside the plain
    version, F and the bound (the plain version's counted work scaled to
    the whole wave). The kernels run and are timed now, the plain walks
    in `plain`. Returns ({mode: H's result}, finish), finish() the
    comparison, returning {mode: (H's result, facts)}."""
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.ops import intersect as isec
    from hairpt_torch.ops import intersect_packed as ipk

    n = ray.o.shape[0]
    sl = _strided(n, share)
    sub = Ray(*[x[sl].contiguous() for x in ray])
    m = sub.o.shape[0]
    fg = rows_geom(packed, leaf)
    live = ray.maxt > ray.mint
    kern_out, pending = {}, []
    for mode in ("closest", "any"):
        closest = mode == "closest"
        kern = isec.closest_hit if closest else isec.any_hit
        f_fn = ipk.closest_hit_packed if closest else ipk.any_hit_packed
        k = kern(bvh, geom, leaf, ray)
        hf = kern(bvh, fg, leaf, ray)
        f = f_fn(packed, leaf, ray)
        bad_f = int(_differ(hf, f, True).sum()) if closest \
            else int(((hf & live) != f).sum())
        # the scene's own primitives against F's packed copy: the
        # triangles' e1, e2 are rounded once from float64 there, from two
        # float32 vertices in F's rows
        own = float((k[1] == f[1]).float().mean()) if closest \
            else float(((k & live) == f).float().mean())
        ms = cuda_ms(lambda: kern(bvh, geom, leaf, ray), 5)
        f_ms = cuda_ms(lambda: f_fn(packed, leaf, ray), 5)
        kern_out[mode] = k
        pending.append((mode, k, bad_f, own, ms, f_ms,
                        plain_job(plain, f"H_{mode}", bvh, geom, leaf,
                                  sub)))

    def finish():
        out = {}
        for mode, k, bad_f, own, ms, f_ms, job in pending:
            closest = mode == "closest"
            p, counts, plain_ms = job()
            bad = int(_differ(tuple(x[sl] for x in k) if closest else k[sl],
                              p, closest).sum())
            bms, bby = h_bound(bvh, geom, leaf, _scaled(counts, n / m), n,
                               mode)
            n_hit = int((p[1] >= 0).sum()) if closest else int(p.sum())
            vs_f = "bit for bit with F" if bad_f == 0 \
                else f"{bad_f} rays OFF F"
            checked = "" if m == n else \
                f"; every {share}th ray against the plain version"
            log(f"H {leaf} {mode} on {label} ({n} rays{checked}, {n_hit} "
                f"hits): {'bit for bit' if bad == 0 else f'{bad} rays DIFFER'}"
                f"; on F's "
                f"primitives {vs_f} (its own primitives: {own:.6f} agree "
                f"with F); kernel {ms:.3f} "
                f"ms, F {f_ms:.3f} ms, plain {plain_ms:.1f} ms on {m} rays "
                f"({counts['steps']} iterations), bound {bms:.4f} ms by "
                f"{bby} ({ms / bms:.1f}x; {counts['nodes']} node rows, "
                f"{counts['prims']} tests)")
            require(bad == 0, f"kernel H ({leaf}, {mode}) differs from its "
                    f"plain version on {bad} rays of {label}")
            require(bad_f == 0, f"kernel H ({leaf}, {mode}) differs from "
                    f"kernel F on {bad_f} rays of {label}")
            out[mode] = (k, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=bby, f_ms=f_ms, max_abs_err=0.0,
                                 rays=n, plain_rays=m, counts=counts,
                                 agree_with_f=own))
            report.setdefault(("perray", leaf, mode), []).append(
                (label, out[mode][1]))
        return out
    return kern_out, finish


def check_kernel_i(label, bvh, geom, leaf, ray, h_kern, stride, report,
                   plain=None):
    """Phase 14a: kernel I (blocks of I_BLOCK rays, the wave padded as the
    traversal pads it) against its plain version on every stride-th
    block (none for stride None), bit for bit, and against kernel H's
    results h_kern on every ray; timed beside the plain version (on the
    blocks checked) and H's bound. The kernel runs and is timed now, the
    plain walk in `plain`; returns finish(h_out), h_out check_kernel_h's
    finished facts."""
    import torch
    from hairpt_torch.integrators import common
    from hairpt_torch.ops import intersect_blocked as iblk

    n = ray.o.shape[0]
    pray, _ = common._pad_ray(ray, I_BLOCK)
    nb = pray.o.shape[0] // I_BLOCK
    blocks = torch.arange(0, nb if stride else 0, stride or 1,
                          device=ray.o.device)
    sel = (blocks[:, None] * I_BLOCK
           + torch.arange(I_BLOCK, device=ray.o.device)).reshape(-1)
    sub = type(pray)(*[x[sel] for x in pray])
    live = ray.maxt > ray.mint
    pending = []
    for mode in ("closest", "any"):
        closest = mode == "closest"
        kern = iblk.closest_hit_blocked if closest else iblk.any_hit_blocked
        k = kern(bvh, geom, leaf, pray, I_BLOCK)
        h = h_kern[mode]
        kn = tuple(x[:n] for x in k) if closest else k[:n]
        diff = _differ(kn, h, True) if closest else kn != (h & live)
        off = torch.nonzero(diff)[:, 0].tolist()
        detail = []
        for i in off[:8]:
            detail.append((i, *((float(kn[0][i]), int(kn[1][i]),
                                 float(h[0][i]), int(h[1][i])) if closest
                                else (bool(kn[i]), bool(h[i])))))
        ms = cuda_ms(lambda: kern(bvh, geom, leaf, pray, I_BLOCK), 3)
        job = plain_job(plain, f"I_{mode}", bvh, geom, leaf, sub, I_BLOCK,
                        counts=dict(steps=0, nodes=0, prims=0)) \
            if len(blocks) else None
        pending.append((mode, k, off, detail, ms, job))

    def finish(h_out):
        for mode, k, off, detail, ms, job in pending:
            closest = mode == "closest"
            bad, plain_ms = 0, None
            counts = dict(steps=0, nodes=0, prims=0)
            if job is not None:
                p, counts, plain_ms = job()
                ks = tuple(x[sel] for x in k) if closest else k[sel]
                bad = int(_differ(ks, p, closest).sum())
            hf = h_out[mode][1]
            scale = nb / max(len(blocks), 1)
            work_ms, _ = bound_ms(0, (F_SLAB_FLOPS * counts["nodes"]
                                      * I_BLOCK
                                      + (F_TRI_FLOPS if leaf == "tri"
                                         else F_HAIR_FLOPS)
                                      * counts["prims"]) * scale)
            plain_s = (f"plain {plain_ms:.1f} ms on the blocks checked "
                       f"({counts['steps']} iterations, {counts['nodes']} "
                       f"block steps, {counts['prims']} lane tests), I's "
                       f"own work {work_ms:.4f} ms by operations (scaled "
                       f"from the blocks checked)" if len(blocks)
                       else "plain version not run on this wave")
            verdict = ("bit for bit" if bad == 0
                       else f"{bad} rays DIFFER") \
                if len(blocks) else "no block against the plain version"
            log(f"I {leaf} {mode} on {label} ({nb} blocks of {I_BLOCK}, "
                f"{len(blocks)} checked): {verdict}; "
                f"against H {len(off)} of {n} rays differ {detail}; kernel "
                f"{ms:.3f} ms (H {hf['ms']:.3f}), {plain_s}, bound "
                f"{hf['bound_ms']:.4f} ms ({ms / hf['bound_ms']:.1f}x)")
            require(bad == 0, f"kernel I ({leaf}, {mode}) differs from its "
                    f"plain version on {bad} rays of {label}")
            require(len(off) <= IH_MAX_DIFF * n, f"kernel I ({leaf}, "
                    f"{mode}) differs from H on {len(off)} rays of {label}")
            report.setdefault(("blocked", leaf, mode), []).append(
                (label, dict(ms=ms, plain_ms=plain_ms,
                             plain_blocks=len(blocks), blocks=nb,
                             bound_ms=hf["bound_ms"],
                             bound_by=hf["bound_by"], work_ms=work_ms,
                             max_abs_err=0.0, rays=n, off_h=len(off))))
    return finish


def furball_walks(scene, wv, report, plain=None):
    """Phase 14a (run in phase 2, on its waves): kernels H and I on the
    full-width furball's camera and first-bounce waves (hair leaf); I's
    plain version on the camera wave's blocks (I_FURBALL_STRIDE). The
    plain walks in `plain`; returns the function that finishes the
    checks."""
    arr = scene.arrays
    finishes = []
    for name, ray in wv.items():
        label = f"the furball's {name} wave"
        h_kern, h_finish = check_kernel_h(label, arr.hair_bvh, arr.hair,
                                          arr.hair_packed, "hair", ray,
                                          report, F_HAIR_PLAIN_SHARE, plain)
        i_finish = check_kernel_i(label, arr.hair_bvh, arr.hair, "hair",
                                  ray, h_kern,
                                  I_FURBALL_STRIDE if name == "camera"
                                  else None, report, plain)
        finishes.append((h_finish, i_finish))
    return lambda: [i_f(h_f()) for h_f, i_f in finishes]


def teapot_walks(report, device="cuda", **load_kw):
    """Phase 14a: kernels H and I on the teapot stand-in's camera and
    first-bounce waves (triangle leaf), I's plain version on every
    block. Returns the scene."""
    import tempfile
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    with tempfile.TemporaryDirectory(prefix="hairpt_teapot_") as tmp:
        scene = load_scene(scene_xmls.write_scene(tmp, "teapot"),
                           spp_override=1, device=device, **load_kw)
    arr = scene.arrays
    wv, _ = mesh_waves(scene)
    for name, ray in wv.items():
        label = f"the teapot's {name} wave"
        h_kern, h_finish = check_kernel_h(label, arr.tri_bvh, arr.tri,
                                          arr.tri_packed, "tri", ray, report)
        check_kernel_i(label, arr.tri_bvh, arr.tri, "tri", ray, h_kern, 1,
                       report)(h_finish())
    return scene


def walk_waves(scene, label, reset_all, warm=True):
    """Phase 14d: the scene rendered with traversal 'perray' and then
    'blocked' (triangles and hair through kernels H and I): with warm,
    one warm-up wave and one or two timed ones, else one timed wave; the
    counts set to 0 just before the timed waves and read just after.
    Returns {traversal: (s/wave, rays/wave, launches of H or I, waves)}."""
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect as isec
    from hairpt_torch.ops import intersect_blocked as iblk
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk

    out = {}
    for trav in ("perray", "blocked"):
        s = with_config(scene, traversal=trav)
        times, rays = [], []

        def progress(done, total, secs, n_rays):
            torch.cuda.synchronize()
            times.append(secs)
            rays.append(n_rays)
        n_timed = 1
        if warm:
            progress, times, rays, n_timed = warm_up(s, f"{label} {trav}")
        reset_all()
        torch.cuda.synchronize()
        img = path.render(s, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        mod = isec if trav == "perray" else iblk
        launches = dict(mod.LAUNCHES)
        plain = dict(isec.PLAIN_ON_CUDA, **iblk.PLAIN_ON_CUDA)
        others = dict(tk.LAUNCHES, **ipk.LAUNCHES)
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        leaves = ("tri",) if scene.arrays.hair is None else ("hair",)
        log(f"{label}, traversal {trav}: {n_timed} timed wave(s): "
            f"{rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s; image mean "
            f"{float(img.mean()):.6f}; launches {launches}")
        require(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                f"{label} ({trav}): non-finite or black")
        require(all(launches[f"{trav}_{lf}_{m}"] > 0 for lf in leaves
                    for m in ("closest", "any")),
                f"{label} ({trav}) did not launch its walk: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"plain walks ran on CUDA tensors: {plain}")
        require(all(v == 0 for v in others.values()),
                f"{label} ({trav}) ran kernels A, B or F: {others}")
        out[trav] = (secs, rays_w, launches, n_timed)
        del img
    return out


def walk_floor(reset_all):
    """Phase 14d: the small furball over the checkerboard with 'perray' and
    'blocked' on the card and with the plain versions on the CPU: image
    means within MEAN_RTOL, each kernel's four instances launched."""
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect as isec
    from hairpt_torch.ops import intersect_blocked as iblk
    from hairpt_torch.scene.furball import furball_floor_scene

    for trav, mod in (("perray", isec), ("blocked", iblk)):
        means = {}
        for dev in ("cuda", "cpu"):
            s = furball_floor_scene(quality=0.1, res=64, depth=8,
                                    device=dev, traversal=trav)
            reset_all()
            means[dev] = float(path.render(s, spp=1).mean())
            if dev == "cuda":
                got = dict(mod.LAUNCHES)
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"furball over the checkerboard, {trav}: image mean card "
            f"{means['cuda']:.6f}, CPU {means['cpu']:.6f}, rel diff "
            f"{rel:.3g}; card launches {got}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"furball over the floor ({trav}): card and CPU differ by "
                f"{rel}")
        require(all(v > 0 for v in got.values()),
                f"the {trav} floor render did not launch every instance: "
                f"{got}")


def _timed(fn, secs):
    """fn, its host seconds (the card synchronised) appended to secs."""
    import torch

    def run(*a):
        t0 = time.time()
        out = fn(*a)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs.append(time.time() - t0)
        return out
    return run


def motion_entry_point(reset_all, device="cuda", quality=HAIR_QUALITY,
                       also=None, **xml_kw):
    """Phase 14b/c: the motion stand-in (scene_xmls.motion: the furball's
    hair at quality 14, the moving teapot, the deformable pair, 16
    animated instances, the animated camera; shutter [0, 1], 1024^2, spp
    4, depth 65): loaded, one warm-up wave, then its four shutter times
    timed in process (s/wave, rays/wave, Mrays/s, the rebuild's and the
    re-pose's host seconds per shutter time, A, B, F and G launches per
    wave, no plain version on the card); the small stand-in on the card
    and with the plain versions on the CPU (means within MEAN_RTOL); and
    the CLI as a subprocess (wall, build and render seconds). also:
    callable(scene) run on the loaded cell after its timed waves, its
    result under "also" (phase 20d's motion-vector wave). xml_kw and
    device "cpu" rehearse it small."""
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    cuda = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="hairpt_motion_") as tmp:
        xml = scene_xmls.write_scene(tmp, "motion", **xml_kw)
        t0 = time.time()
        scene = load_scene(xml, hair_quality=quality, device=device)
        built = time.time() - t0
        spp = scene.config.spp
        log(f"motion stand-in loaded in {built:.1f}s: "
            f"{scene.arrays.hair.p0.shape[0]} segments, "
            f"{scene.arrays.tri.p0.shape[0]} triangles, "
            f"{len(scene.arrays.inst.proto_ids)} instances, "
            f"{scene.config.width}^2, spp {spp}, shutter {scene.shutter}")
        reb, rep = [], []
        scene = scene._replace(
            rebuild_geo=_timed(scene.rebuild_geo, reb),
            repose_inst=_timed(scene.repose_inst, rep))
        times, rays = [], []

        def progress(done, total, secs, n_rays):
            if cuda:
                torch.cuda.synchronize()
            times.append(secs)
            rays.append(n_rays)
        path.render(scene, spp=1, seed=0, progress=progress)
        log(f"motion: warm-up wave (shutter time 0.5) {times[0]:.2f}s")
        times.clear()
        rays.clear()
        reb.clear()
        rep.clear()
        reset_all()
        if cuda:
            torch.cuda.synchronize()
        img = path.render(scene, spp=spp, seed=1, progress=progress)
        if cuda:
            torch.cuda.synchronize()
        ab, f_l, g_l = dict(tk.LAUNCHES), dict(ipk.LAUNCHES), \
            dict(gi.LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA,
                     **gi.PLAIN_ON_CUDA)
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        launches = dict(ab, **f_l, **g_l)
        log(f"motion render: {spp} waves (shutter times "
            f"{[round((s + 0.5) / spp, 4) for s in range(spp)]}) at "
            f"{scene.config.width}^2, depth {scene.config.max_depth}: "
            f"{rays_w:.0f} rays/wave, {secs:.3f} s/wave (each "
            f"{[round(x, 3) for x in times]}), {rays_w / secs / 1e6:.4f} "
            f"Mrays/s; the triangles' rebuild {[round(x, 4) for x in reb]} "
            f"s and the instances' re-pose {[round(x, 4) for x in rep]} s "
            f"per shutter time (host); image mean {float(img.mean()):.6f}; "
            f"launches per wave "
            f"{ {k: v / spp for k, v in launches.items()} }")
        require(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                "motion render: non-finite or black")
        require(len(reb) == len(rep) == spp, f"motion: {len(reb)} rebuilds "
                f"and {len(rep)} re-poses over {spp} shutter times")
        if cuda:
            require(all(v > 0 for v in ab.values())
                    and f_l["packed_tri_closest"] > 0
                    and f_l["packed_tri_any"] > 0
                    and all(v > 0 for v in g_l.values()),
                    f"the motion render did not launch A, B, F and G: "
                    f"{launches}")
            require(all(v == 0 for v in plain.values()),
                    f"plain versions ran on CUDA tensors: {plain}")
        result = dict(secs=secs, rays=rays_w, launches=launches, waves=spp,
                      rebuild_s=list(reb), repose_s=list(rep),
                      build_s=built)
        if also is not None:
            result["also"] = also(scene)
        del scene, img

        # 14c's CLI (one shutter time at CLI_WIDTH across; the XML's
        # width is 1024 on the card) runs beside 14b's small renders
        cli_h = _cli_start(xml, os.path.join(tmp, "out", "motion.png"),
                           quality, device, spp=1, res_scale=min(
                               1.0, CLI_WIDTH / xml_kw.get("res", 1024)))
        # 14b: small, card against CPU
        small = os.path.join(tmp, "small")
        sxml = scene_xmls.write_scene(small, "motion", **MOTION_SMALL)
        means = {}
        for dev in (("cuda", "cpu") if cuda else ("cpu",)):
            s = load_scene(sxml, hair_quality=MOTION_SMALL_QUALITY,
                           device=dev)
            t0 = time.time()
            means[dev] = float(path.render(s).mean())
            log(f"motion small ({s.config.width}^2, depth "
                f"{s.config.max_depth}, spp {s.config.spp}) on {dev}: "
                f"{time.time() - t0:.1f}s, image mean {means[dev]:.6f}")
        if cuda:
            rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                          1e-12)
            log(f"motion small: card against CPU rel diff {rel:.3g}")
            require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                    f"motion small: card and CPU differ by {rel}")

        # 14c: the CLI
        wall, t_build, t_render, img = _cli_wait(cli_h)
        require(np.isfinite(img).all() and img.mean() > 0,
                f"motion CLI image mean {img.mean()}")
        log(f"CLI motion ({img.shape[1]} x {img.shape[0]}, 1 spp): exit "
            f"0 in {wall:.1f}s wall beside the small renders, scene built "
            f"in {t_build}s, rendered in {t_render}s; image mean "
            f"{img.mean():.6f}; four outputs")
        result.update(cli_wall=wall, cli_build=t_build, cli_render=t_render)
    return result


def hi_kernel_entries(report, launches):
    """The kernels line's entries for kernels H and I: one per leaf and
    mode, its time on the first wave checked, its launches over phase
    14d's timed waves (launches: {traversal: (launches, waves)} for the
    furball's and the teapot's)."""
    entries = []
    for (trav, leaf, mode), rows in sorted(report.items()):
        (label, f), *rest = rows
        name = f"{trav}_{leaf}_{mode}"
        n, waves = launches[(trav, leaf)]
        entries.append(dict(
            name=name, route="cuda",
            source=f"hairpt_torch/csrc/{trav}.cu",
            replaces=(H_REPLACES if trav == "perray" else I_REPLACES)[mode],
            launches=n[name], max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None, timed_on=label,
            plain_rays=f.get("plain_rays"),
            launched_by=(f"the {'teapot' if leaf == 'tri' else 'furball'}'s "
                         f"'{trav}' waves (phase 14d)"),
            launches_per_wave=n[name] / waves,
            other_waves={lb: {k: x[k] for k in ("ms", "plain_ms", "bound_ms")}
                         for lb, x in rest}))
    return entries


# ---------------------------------------------------------------------------
# phase 15: the tiled query's options (subcull, short_t, two_round) and the
# area and delta lights (the lit stand-in)
# ---------------------------------------------------------------------------

#  the options against the default query on a whole wave: hit flags and
#      pids equal on >= OPT_MIN_AGREE of the rays (subcull loses a hit
#      that lies outside its segment's sub-cluster box, as hairpt's does:
#      every differing ray must be such a ray), t bit for bit where a
#      closest-hit pid is equal
OPT_MIN_AGREE = 0.9999
#  short-ray-first's clamp: 4x the median cluster-box diagonal (a few
#      cluster diameters, hairpt/scene/scene.py:104's comment)
SHORT_T_DIAGS = 4.0
#  two_round's first round: each tile's 256 nearest clusters
TWO_ROUND = 256


def short_t_of(sw):
    """The short-ray-first clamp of the rule above, for a cluster layout."""
    import torch
    return SHORT_T_DIAGS * float(
        torch.linalg.norm(sw.cl_hi - sw.cl_lo, dim=1).median())


def _host_ms(fn, reps=2):
    """Host milliseconds per call of fn (a whole query, host syncs
    included), the card synchronised, after a warm-up call; and its
    last result."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / reps, out


def sub_kernel_a(sw, name, r8, report):
    """Phase 15a: kernel A over the sub-cluster boxes [6, C K/32] against
    its plain version on EVERY tile of a wave (2a's rules), timed beside
    the cluster-box instance and its bound (this wave's work: each live
    (tile, sub-box) tile test and each live ray against the sub-boxes its
    tile's rays enter); kernel B's routed and run slots and time on the
    first routing pass of the cluster-box and of the sub-box cull."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sub = itiled.sub_bounds(sw)
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    T, C4 = r8.shape[0], sub.shape[1]
    te_k, tpm_k = tk.cull_phase_a(r8, sub, sub=True)
    out = {}
    plain_ms = cuda_ms(lambda: out.update(p=tk.cull_phase_a_plain(
        r8, sub, sub=True)), 1, warm=False)
    te_p, tpm_p = out.pop("p")
    a = te_k.view(torch.int16).int() & 0x7FFF
    b = te_p.view(torch.int16).int() & 0x7FFF
    steps = int((a - b).abs().max())
    fin = torch.isfinite(te_p.float())
    te_err = float((te_k.float() - te_p.float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    both_neg = (tpm_k < 0) & (tpm_p < 0)
    tp_rel = float(torch.where(both_neg, 0.0, (tpm_k - tpm_p).abs()
                               / tpm_p.abs().clamp(min=1e-30)).max())
    live = r8[:, 7, :] > r8[:, 6, :]
    live_t = int(live.any(1).sum())
    ray_tests = int((fin.sum(1) * live.sum(1)).sum())
    del te_p, tpm_p
    require(steps <= TE_MAX_BF16_STEPS and tp_rel <= TPMAX_RTOL,
            f"{name}: kernel A over the sub-boxes differs from its plain "
            f"version ({steps} bf16 steps, t_pmax rel {tp_rel})")
    ms = cuda_ms(lambda: tk.cull_phase_a(r8, sub, sub=True), 5)
    ms_c = cuda_ms(lambda: tk.cull_phase_a(r8, bounds), 5)
    # kernel B on the first routing pass of each: the clusters a tile's
    # rays enter (cluster boxes, or any of a cluster's sub-boxes), the
    # slots routed, the slots run before the early exit, B's time
    C = bounds.shape[1]
    ks = itiled.KeySpace(C)
    te_c, tpm_c = tk.cull_phase_a(r8, bounds)
    q = report["q"]
    b_facts = []
    for label, te, tpm in (("cluster boxes", te_c, tpm_c),
                           ("sub-boxes", te_k.view(T, C, C4 // C).amin(2),
                            tpm_k)):
        slots, cnt, tmin, tscale, _, _ = itiled._tile_slots(ks.keys(te), ks,
                                                            q)
        args = (slots, cnt, tmin, tscale, r8, tpm, sw.seg_rows_t, bounds)
        _, _, run = tk.phase_b(*args, False, True)
        ms_b = cuda_ms(lambda: tk.phase_b(*args), 3)
        b_facts.append((label, float(torch.isfinite(te.float()).sum(1)
                                     .float().mean()), int(cnt.sum()),
                        int(run.sum()), ms_b))
    log(f"{name}: kernel B on the first routing pass, closest hit: "
        + "; ".join(f"{lb}: {cand:.1f} clusters/tile, {n_sl} slots routed, "
                    f"{n_run} run, {ms_b:.3f} ms"
                    for lb, cand, n_sl, n_run, ms_b in b_facts))
    n_bytes = T * 8 * 64 * 4 + 6 * C4 * 4 + T * 64 * 4 + T * C4 * 2
    bnd = bound_ms(n_bytes, live_t * C4 * TILE_TEST_FLOPS
                   + ray_tests * SLAB_FLOPS)
    log(f"{name}: kernel A over the {C4} sub-boxes on all {T} tiles (plain "
        f"{plain_ms:.1f} ms): max bf16 step diff {steps}, max |te diff| "
        f"{te_err:.3g}, max t_pmax rel diff {tp_rel:.3g}; candidates/tile "
        f"{float(fin.sum(1).float().mean()):.1f}; {ms:.3f} ms (over the "
        f"{bounds.shape[1]} cluster boxes {ms_c:.3f} ms); bound from this "
        f"wave's work {bnd[0]:.3f} ms by {bnd[1]} ({ms / bnd[0]:.1f}x)")
    pre = "" if name == "camera" else "bounce_"
    report.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                   f"{pre}bound_ms": bnd[0], f"{pre}bound_by": bnd[1],
                   f"{pre}cluster_box_ms": ms_c,
                   f"{pre}b_slots_run": [f[3] for f in b_facts],
                   f"{pre}b_ms": [f[4] for f in b_facts]})
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), te_err)


def tiled_options(scene, wv):
    """Phase 15a: kernel A over the sub-cluster boxes on both waves
    (sub_kernel_a), then subcull, short_t and two_round through the whole
    query, closest and any hit, against the default query on each wave;
    each differing ray is checked against its segment's sub-cluster box
    (intersect_tiled.outside_sub_box) and counted. Each query is timed
    beside the default. Returns the facts of the sub-box instance for
    the kernels line."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    q = scene.config.tiled_q
    st = short_t_of(sw)
    log(f"short_t = {SHORT_T_DIAGS} x the median cluster-box diagonal = "
        f"{st:.6g}; two_round = {TWO_ROUND}; q = {q}")
    report = {"q": q}
    for name, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        sub_kernel_a(sw, name, itiled.rays8_of(ray_p), report)
        for mode in ("closest", "any"):
            ms_d, (t_d, p_d) = _host_ms(lambda: itiled.tiled_closest_hit(
                sw, ray, q, mode=mode))
            opts = {"subcull": dict(subcull=True),
                    "short_t": dict(short_t=st, sort_rays=True)}
            if mode == "closest":     # hairpt's two_round is closest-only
                opts["two_round"] = dict(two_round=TWO_ROUND)
            line = []
            for opt, kw in opts.items():
                ms, (t_o, p_o) = _host_ms(lambda: itiled.tiled_closest_hit(
                    sw, ray, q, mode=mode, **kw))
                differ = (p_o != p_d) | ((p_o >= 0) != (p_d >= 0))
                agree = 1.0 - float(differ.float().mean())
                n_diff = int(differ.sum())
                t_same = True
                if mode == "closest":
                    same = ~differ & (p_d >= 0)
                    t_same = bool(torch.equal(t_o[same], t_d[same]))
                n_out = 0
                if n_diff:
                    t_c, p_c = itiled.tiled_closest_hit(sw, ray, q)
                    lost = differ & (p_c >= 0)
                    pt = ray.o[lost] + ray.d[lost] * t_c[lost, None]
                    n_out = int((itiled.outside_sub_box(
                        sw, p_c[lost], pt) > 0).sum())
                    require(n_out == n_diff, f"{name}/{mode}/{opt}: "
                            f"{n_diff - n_out} differing rays lie inside "
                            f"their segment's sub-cluster box")
                require(agree >= OPT_MIN_AGREE and t_same,
                        f"{name}/{mode}/{opt}: agreement {agree}, t equal "
                        f"where pids are {t_same}")
                line.append(f"{opt} {ms:.1f} ms ({n_diff} differ, "
                            f"{n_out} outside their sub-box)")
            log(f"{name} wave, {mode}: default {ms_d:.1f} ms, "
                + ", ".join(line) + f"; hits {int((p_d >= 0).sum())}")
    return report


def option_renders(scene, reset_all):
    """Phase 15b: phase 4's full-width furball with traversal 'tiled_sub'
    and with tiled_short > 0 (short_t_of): one warm-up and one timed
    1-spp wave each, the launches of A (per instance) and B over the
    timed wave. Returns the sub-box instance's launches and the facts."""
    import numpy as np
    import torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import tiled_kernels as tk

    st = short_t_of(scene.arrays.hair_swept)
    out = {}
    for label, fields in (("tiled_sub", dict(traversal="tiled_sub")),
                          ("tiled_short", dict(tiled_short=st))):
        s = with_config(scene, **fields)
        path.render(s, spp=1, seed=0)
        reset_all()
        torch.cuda.synchronize()
        t0 = time.time()
        img, stats = path.render(s, spp=1, seed=1, return_stats=True)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = dict(tk.LAUNCHES, **tk.SUB_LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA, **tk.SUB_PLAIN_ON_CUDA)
        mean = float(img.mean())
        log(f"{label} render (1024^2, depth 65, q {s.config.tiled_q}"
            + (f", tiled_short {st:.6g}" if label == "tiled_short" else "")
            + f"): timed wave {secs:.3f} s, {stats['rays']:.0f} rays, "
            f"{stats['rays'] / secs / 1e6:.4f} Mrays/s; image mean "
            f"{mean:.6f}; launches {launches}")
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"{label} render: image mean {mean}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
        sub = label == "tiled_sub"
        require(launches["phase_b"] > 0
                and (launches["cull_phase_a_sub"] > 0) == sub
                and (launches["cull_phase_a"] > 0) != sub,
                f"{label} render: kernel A's instances or B not launched "
                f"as the traversal asks: {launches}")
        out[label] = dict(secs=secs, rays=stats["rays"], launches=launches)
    return out


def _rot(axis, deg):
    """The loader's <rotate> matrix (Rodrigues)."""
    import numpy as np
    ax = np.asarray(axis, np.float64)
    ax = ax / np.linalg.norm(ax)
    ang = np.radians(float(deg))
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    t = np.eye(4)
    t[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    return t


def lit_builder(res=1024, device="cuda", quality=HAIR_QUALITY):
    """Phase 15c's twin of the lit stand-in (scene_xmls.lit) through
    SceneBuilder with the values the loader reads: phase 11's furball,
    the rectangle (scaled 2.5, turned 90 degrees about x, at y 17) and
    the sphere (radius 0.6 at (5, 11.5, -3)) area lights, each under a
    default diffuse row, the spot light (its toWorld's position and +z)
    and the point light (the loader's direction and angle defaults)."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.core.math import matrix_lookat
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import emitters as em
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene import furball, hairgen
    from hairpt_torch.scene.scene import SceneBuilder

    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.ROUGHPLASTIC, twosided=False,
                       eta=1.55 / 1.000277, diffuse=furball.DIFFUSE,
                       alpha=0.2, dist=0)
    radius = 0.00216667 / np.sqrt(min(max(quality, 1e-6), 1.0))
    b.add_fibers(hairgen.gen_furball(n_fibers=int(6000 * quality),
                                     radius=radius), m)
    s = np.eye(4)
    s[0, 0] = s[1, 1] = s[2, 2] = 2.5
    tr = np.eye(4)
    tr[:3, 3] = (0.0, 17.0, 0.0)
    b.add_mesh(shp.rectangle(), b.add_material(kind=mat.DIFFUSE),
               to_world=tr @ (_rot((1, 0, 0), 90) @ s),
               radiance=(6.0, 5.6, 5.0))
    c = np.eye(4)
    c[:3, 3] += np.asarray((5.0, 11.5, -3.0))
    b.add_mesh(shp.sphere(0.6), b.add_material(kind=mat.DIFFUSE),
               to_world=c, radiance=(4.0, 6.0, 9.0))
    spot = matrix_lookat((8.0, 15.0, -8.0), (0.0, 11.0, 0.0),
                         (0.0, 1.0, 0.0))
    b.delta_lights.append(dict(
        kind=em.SPOT, position=tuple(spot[:3, 3]),
        direction=tuple(spot[:3, :3] @ [0, 0, 1]),
        intensity=(300.0, 300.0, 300.0), cutoff_deg=25.0,
        beam_deg=25.0 * 0.75))
    b.delta_lights.append(dict(
        kind=em.POINT, position=(-6.0, 16.0, 6.0),
        direction=tuple(np.eye(3) @ [0, 0, 1]),
        intensity=(60.0, 50.0, 40.0), cutoff_deg=20.0, beam_deg=15.0))
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, device=b.device)
    cam = Camera.perspective(furball.CAM_TO_WORLD, 35.0, res, res)
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, int(np.ceil(np.log2(res))), res))


def _cli_start(xml, out, quality, device, spp=2, res_scale=1.0, extra=(),
               before=()):
    """Start the CLI as a subprocess, as a user runs it (its stderr in a
    file beside `out`); _cli_wait collects it. The CLIs of phases 15c-19f
    run beside their phase's scene load or CPU renders: most of a CLI's
    wall is the interpreter's and the card's start-up. before: commands
    (argument lists) run first, in one shell chain with the render, each
    of which must exit 0."""
    import shlex
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    err = open(out[:-4] + ".stderr", "w+")
    cmd = [sys.executable, "-m", "hairpt_torch.cli", "render", xml, "-o",
           out, "--hair-quality", str(min(quality, CLI_HAIR_QUALITY)),
           "--spp", str(spp), "--res-scale", str(res_scale)] + list(extra) \
        + (["--cpu"] if device == "cpu" else [])
    if before:
        cmd = ["sh", "-c", " && ".join(shlex.join(c)
                                       for c in list(before) + [cmd])]
    proc = subprocess.Popen(cmd, cwd=here, env=env,
                            stdout=subprocess.DEVNULL, stderr=err)
    return proc, err, out, time.time()


def _stop(*procs):
    """Kill and reap each of the started processes that still runs."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _cli_wait(handle, exts=("png", "exr", "npy", "pfm")):
    """(wall seconds, its logged build and render seconds, the .npy image
    or None without one) of a started CLI; it must exit 0 with an output
    of each extension in exts (the banded render writes only its EXR)."""
    import re
    import numpy as np
    proc, err, out, t0 = handle
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.time() - t0
    err.seek(0)
    stderr = err.read()
    err.close()
    require(rc == 0, f"the CLI exited {rc}:\n{stderr[-3000:]}")
    built = re.search(r"scene built in ([0-9.]+)s", stderr)
    rendered = re.search(r"rendered in ([0-9.]+)s", stderr)
    require(built is not None and rendered is not None,
            f"the CLI logged no build or render time:\n{stderr}")
    base = out[:-4]
    for ext in exts:
        require(os.path.getsize(f"{base}.{ext}") > 0, f"no {ext} output")
    return (wall, float(built.group(1)), float(rendered.group(1)),
            np.load(f"{base}.npy") if "npy" in exts else None)


def lit_cell(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
             small_res=64, small_quality=0.1):
    """Phase 15c: the lit stand-in (scene_xmls.lit: the XML furball under
    a rectangle and a sphere area light, a spot and a point light and the
    sunsky). The CLI at min(res, CLI_WIDTH)^2, hair quality
    min(quality, CLI_HAIR_QUALITY),
    depth 65, 1 spp: exit 0, four outputs, a finite positive mean. In
    process: load_scene against lit_builder (config and every tensor
    equal), one warm-up and one timed 1-spp wave (s/wave, Mrays/s, A, B
    and F launches, no plain
    version on the card). Then at small_res (hair quality small_quality,
    depth 8): the render card against CPU (MEAN_RTOL), the diffuse
    gradient card against CPU (3b's bounds), and PRB against the
    differentiable mode on the card at depth 3. Returns the in-process
    facts (None on the CPU, where a small res and quality rehearse it)."""
    import tempfile
    tmp_dir = tempfile.TemporaryDirectory(prefix="hairpt_lit_")
    try:
        return _lit_cell(reset_all, device, res, quality, small_res,
                         small_quality, tmp_dir.name)
    finally:
        tmp_dir.cleanup()


def _lit_cell(reset_all, device, res, quality, small_res, small_quality,
              tmp):
    import numpy as np
    import torch
    from hairpt_torch.integrators import inverse, path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    xml = scene_xmls.write_scene(tmp, "lit", res=res)
    xml_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "lit",
                                   res=small_res)
    cw = min(res, CLI_WIDTH)
    cli_h = _cli_start(
        xml, os.path.join(tmp, "out", "lit.png"), quality, device, spp=1,
        res_scale=cw / res)
    t0 = time.time()
    scene = load_scene(xml, hair_quality=quality, spp_override=1,
                       device=device)
    t_load = time.time() - t0
    scene_b = lit_builder(res, device, quality)
    require(scene.config == scene_b.config,
            f"configs differ: {scene.config} {scene_b.config}")
    pairs = list(zip(_scene_tensors(scene.arrays),
                     _scene_tensors(scene_b.arrays)))
    require(len(pairs) > 10 and all(
        pa == pb and _same_bits(x, y) for (pa, x), (pb, y) in pairs),
        "the lit XML's arrays differ from the builder's: "
        + str([pa for (pa, x), (pb, y) in pairs if pa != pb
               or not _same_bits(x, y)]))
    del scene_b
    wall, t_build, t_render, img = _cli_wait(cli_h)
    require(img.shape == (cw, cw, 3) and np.isfinite(img).all()
            and img.mean() > 0, f"lit CLI image {img.shape}, mean "
            f"{img.mean()}")
    log(f"CLI lit ({cw}^2, hair quality {min(quality, CLI_HAIR_QUALITY)}, "
        f"depth 65, 1 spp): "
        f"exit 0 in {wall:.1f}s wall beside the scene load, scene built "
        f"in {t_build}s, rendered in {t_render}s; image mean "
        f"{img.mean():.6f}; four outputs")
    a = scene.arrays
    log(f"lit: loaded in {t_load:.1f}s, {len(pairs)} tensors equal to "
        f"SceneBuilder's; {a.hair.p0.shape[0]} segments, "
        f"{a.tri.p0.shape[0]} triangles ({a.area.cdf.shape[0]} emissive), "
        f"delta lights {a.delta.kind.tolist()}, nee_probs "
        f"{scene.config.nee_probs}")
    facts = None
    if device == "cuda":
        progress, times, rays, n_timed = warm_up(scene, "lit", max_timed=1)
        reset_all()
        torch.cuda.synchronize()
        img = path.render(scene, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES, **ipk.LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        mean = float(img.mean())
        log(f"lit render: {n_timed} timed waves of 1 spp at {res}^2, depth "
            f"65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s; image mean {mean:.6f}; "
            f"launches over the timed waves {launches}")
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"lit render: image mean {mean}")
        require(launches["cull_phase_a"] > 0 and launches["phase_b"] > 0
                and launches["packed_tri_closest"] > 0
                and launches["packed_tri_any"] > 0,
                f"the lit render did not launch A, B and F: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
        facts = dict(secs=secs, rays=rays_w, n_timed=n_timed,
                     launches=launches)
        del img
    del scene

    # small: card against CPU (render, gradient), PRB on the card
    devs = ("cuda", "cpu") if device == "cuda" else ("cpu",)
    means, grads = {}, {}
    for dev in devs:
        s = load_scene(xml_s, hair_quality=small_quality, spp_override=1,
                       max_depth_override=8, device=dev)
        means[dev] = float(path.render(s, spp=1).mean())
        grads[dev] = scan_ad_grad(s, {"diffuse": s.arrays.materials.diffuse})
    if device == "cuda":
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        (l_k, g_k, _), (l_p, g_p, _) = grads["cuda"], grads["cpu"]
        scale = float(g_p["diffuse"].abs().max())
        err = float((g_k["diffuse"].cpu() - g_p["diffuse"]).abs().max())
        lrel = abs(l_k - l_p) / max(abs(l_p), 1e-12)
        log(f"small lit ({small_res}^2, hair quality {small_quality}, depth "
            f"8): image mean card {means['cuda']:.6f}, CPU "
            f"{means['cpu']:.6f}, rel diff {rel:.3g}; diffuse gradient loss "
            f"rel diff {lrel:.3g}, largest gradient diff {err:.3g} = "
            f"{err / scale:.3g} of the largest |g| ({scale:.4g})")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small lit render: card and CPU differ by {rel}")
        require(lrel <= GRAD_LOSS_RTOL and err <= GRAD_REL * scale,
                f"small lit gradient: card and CPU differ (loss {lrel}, "
                f"gradient {err / scale} of the largest)")
    s = load_scene(xml_s, hair_quality=small_quality, spp_override=1,
                   max_depth_override=3, device=devs[0])
    s = with_config(s, rr_depth=999)
    params = {"diffuse": s.arrays.materials.diffuse}
    l_s, g_s, _ = scan_ad_grad(s, params)
    n = s.config.width * s.config.height
    pix = torch.arange(n, device=s.arrays.device)
    l_r, g_r = inverse.make_prb_loss_grad(s)(s.arrays, params, pix,
                                             torch.zeros_like(pix))
    prel = float((g_r["diffuse"] - g_s["diffuse"]).abs().max()
                 / g_s["diffuse"].abs().max().clamp(min=1e-12))
    lrel = abs(float(l_r) - l_s) / max(abs(l_s), 1e-12)
    log(f"small lit, PRB vs the differentiable mode on {devs[0]}, depth 3: "
        f"loss {float(l_r):.6f} / {l_s:.6f} (rel {lrel:.3g}), diffuse "
        f"gradient diff over its largest |g| {prel:.3g}")
    require(lrel <= PRB_LOSS_RTOL and prel <= PRB_REL,
            f"small lit: PRB differs from the differentiable mode (loss "
            f"{lrel}, gradient {prel})")
    return facts


def sub_kernel_entry(rep, launches):
    """The kernels line's entry of kernel A's sub-box instance: 15a's
    times on the camera wave (bounce_*: the first-bounce wave's), the
    launches of 15b's timed tiled_sub wave."""
    r = dict(rep)
    r.pop("q")
    return dict(
        name="cull_phase_a_sub", route="cuda",
        source="hairpt_torch/csrc/tiled.cu",
        replaces="hairpt/ops/pallas_tiled.py:882", launches=launches,
        max_abs_err=r.pop("max_abs_err"), ms=r.pop("ms"),
        plain_ms=r.pop("plain_ms"), bound_ms=r.pop("bound_ms"),
        bound_by=r.pop("bound_by"), library_ms=None,
        launched_by="the timed tiled_sub wave of phase 15b",
        bound_basis="bound_ms: the work of this run's camera wave over the "
        "sub-cluster boxes (live (tile, sub-box) tile tests, live-ray tests "
        "of the sub-boxes the tile's rays enter)", **r)


# ---------------------------------------------------------------------------
# phase 16: rendering and the inverse step across GPUs (16a, 16b), the
# materials cell (16c) and the other sensors (16d)
# ---------------------------------------------------------------------------
#  16a/16b, a sharded render against one process: each pixel value within
#      SHARD_RTOL relative + SHARD_ATOL (tests/test_grad_and_sharding.py's
#      bound for hairpt's sharded render), at most SHARD_OUT_MAX of the
#      values outside it (the film's float index_add sums in any order on
#      the card), the image means within SHARD_MEAN_RTOL; the parameters
#      after a train step within SHARD_PARAM_RTOL relative
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-5
SHARD_OUT_MAX = 1e-4
SHARD_MEAN_RTOL = 1e-5
SHARD_PARAM_RTOL = 1e-5
SHARD_LR = 0.05
# 16b's small furball (6,000 fibers, 256^2, depth 8) and its two ranks'
# time limit
GLOO_QUALITY, GLOO_RES, GLOO_DEPTH = 1.0, 256, 8
GLOO_TIMEOUT = 240


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_process_step(scene, target, params, seed=0, spp=1, lr=SHARD_LR):
    """parallel.mesh.make_train_step's step in one process, from the
    port's inverse code: the differentiable mode over every pixel in
    plain order at sample index seed * 131 + s, the loss on the
    developed film, SGD. Returns the parameters."""
    import torch
    from hairpt_torch.film import film as film_mod
    from hairpt_torch.integrators import inverse, path

    dev = scene.arrays.device
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    arrays = inverse.apply_params(scene, leaves)
    li = path.make_li_fn(scene, differentiable=True)
    n = scene.config.width * scene.config.height
    pix = torch.arange(n, device=dev)
    image, weight = film_mod.zeros(scene.film, dev)
    for s in range(spp):
        rad, pos, _ = li(arrays, pix, torch.full_like(pix, seed * 131 + s))
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        image, weight = film_mod.splat_samples(scene.film, pos, rad, image,
                                               weight)
    loss = torch.mean((film_mod.develop(image, weight) - target) ** 2)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return {k: (leaves[k] - lr * g).detach() for k, g in zip(names, grads)}


def one_process_wave(scene, sample):
    """One wave in plain pixel order at sample index `sample`, splatted
    and developed: the sharded wave without the split and the reduce."""
    import torch
    from hairpt_torch.film import film as film_mod
    from hairpt_torch.integrators import path

    dev = scene.arrays.device
    n = scene.config.width * scene.config.height
    pix = torch.arange(n, device=dev)
    with torch.no_grad():
        rad, pos, _ = path.make_li_fn(scene)(scene.arrays, pix,
                                            torch.full_like(pix, sample))
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        img, wt = film_mod.splat_samples(scene.film, pos, rad,
                                         *film_mod.zeros(scene.film, dev))
    return film_mod.develop(img, wt)


def image_agreement(img, ref, label):
    """Require SHARD_*'s bounds; returns (share outside, mean rel diff)."""
    import torch
    img, ref = img.float().cpu(), ref.float().cpu()
    out = 1.0 - float(torch.isclose(img, ref, rtol=SHARD_RTOL,
                                    atol=SHARD_ATOL).float().mean())
    m_ref = float(ref.double().mean())
    mrel = abs(float(img.double().mean()) - m_ref) / max(abs(m_ref), 1e-30)
    require(bool(torch.isfinite(img).all()) and m_ref > 0,
            f"{label}: non-finite or black image (mean {m_ref})")
    require(out <= SHARD_OUT_MAX and mrel <= SHARD_MEAN_RTOL,
            f"{label}: {out:.3g} of the values outside rtol {SHARD_RTOL} / "
            f"atol {SHARD_ATOL}, means differ by {mrel:.3g}")
    return out, mrel


def params_agreement(p, ref, label):
    import torch
    worst = 0.0
    for k, v in ref.items():
        a, b = p[k].detach().float().cpu(), v.detach().float().cpu()
        worst = max(worst, float(((a - b).abs()
                                  / b.abs().clamp(min=1e-30)).max()))
    require(worst <= SHARD_PARAM_RTOL,
            f"{label}: the parameters differ by {worst:.3g} relative")
    return worst


def gloo_scene(device="cuda", small=(GLOO_QUALITY, GLOO_RES, GLOO_DEPTH)):
    return bench_scene(quality=small[0], res=small[1], depth=small[2],
                       spp=1, device=device)


def gloo_worker(argv):
    """One rank of 16b, run as `chip_smoke.py --gloo-rank RANK WORLD PORT
    DIR DEVICE QUALITY RES DEPTH`: gloo over the one card (or the CPU), the
    small furball's sharded render and one train step, written to
    DIR/rank{RANK}.npz."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hairpt_torch.parallel import mesh as pmesh
    rank, world, port, out_dir, device = argv[:5]
    small = (float(argv[5]), int(argv[6]), int(argv[7]))
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    torch.set_num_threads(1)
    pmesh.init(device=device, backend="gloo")
    s = gloo_scene(device, small)
    mesh = pmesh.default_mesh()
    img = pmesh.render_sharded(s, mesh, spp=1, seed=0)
    step = pmesh.make_train_step(s, mesh, torch.zeros_like(img), spp=1,
                                 lr=SHARD_LR)
    p, loss = step({"diffuse": s.arrays.materials.diffuse}, 0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), img=img.cpu().numpy(),
             diffuse=p["diffuse"].cpu().numpy(), loss=float(loss))
    torch.distributed.destroy_process_group()
    return 0


def sharded_cells(scene, reset_all, device="cuda",
                  small=(GLOO_QUALITY, GLOO_RES, GLOO_DEPTH), between=None):
    """16a: NCCL at world size 1 (a local TCP rendezvous): render_sharded
    on phase 4's furball (a warm-up and a timed wave) against the same
    wave in one process; the film all_reduce's ms; make_train_step on
    phase 6's scene (depth 16, the diffuse table) against the one-process
    step; the small furball's render and step at world size 1 for 16b.
    16b: two gloo ranks on the one card (subprocesses with a time limit)
    on the small furball against 16a's world-size-1 results; between(),
    when given, runs while they work (its times then share the card).
    Returns the facts."""
    import numpy as np
    import tempfile
    import torch
    import torch.distributed as dist
    from concurrent.futures import ThreadPoolExecutor
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.parallel import mesh as pmesh

    cuda = device == "cuda"
    port = _free_port()
    dev = pmesh.init(device=device, init_method=f"tcp://127.0.0.1:{port}",
                     rank=0, world_size=1)
    require(dist.get_backend() == ("nccl" if cuda else "gloo"),
            f"16a: backend {dist.get_backend()} on {dev}")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    facts = {}
    try:
        mesh = pmesh.default_mesh()
        t0 = time.time()
        pmesh.render_sharded(scene, mesh, spp=1, seed=0)
        sync()
        warm = time.time() - t0
        reset_all()
        sync()
        t0 = time.time()
        img = pmesh.render_sharded(scene, mesh, spp=1, seed=1)
        sync()
        secs = time.time() - t0
        launches = dict(tk.LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA)
        ref = one_process_wave(scene, 65536)
        out, mrel = image_agreement(img, ref, "16a sharded furball")
        h, w = img.shape[:2]
        require(not cuda or (all(v > 0 for v in launches.values())
                             and all(v == 0 for v in plain.values())),
                f"16a: launches {launches}, plain versions {plain}")
        buf = torch.zeros(h * w * 4, device=dev)
        ar_ms = cuda_ms(lambda: dist.all_reduce(buf), 20) if cuda else None
        log(f"16a sharded furball ({dist.get_backend()}, world 1, "
            f"{w}x{h}, depth {scene.config.max_depth}, q "
            f"{scene.config.tiled_q}): warm-up {warm:.2f}s, timed wave "
            f"{secs:.3f} s/wave; against one process: {out:.3g} of the "
            f"values outside rtol {SHARD_RTOL} / atol {SHARD_ATOL}, means "
            f"rel diff {mrel:.3g}; launches {launches}; the film all_reduce "
            f"({h * w * 4 * 4 / 2**20:.0f} MiB, world 1) {ar_ms} ms")
        del img, ref
        # the train step on phase 6's scene
        s6 = with_config(scene, max_depth=16)
        target = torch.zeros((s6.config.height, s6.config.width, 3),
                             device=dev)
        p0 = {"diffuse": s6.arrays.materials.diffuse}
        step = pmesh.make_train_step(s6, mesh, target, spp=1, lr=SHARD_LR)
        sync()
        t0 = time.time()
        p_sh, loss = step(p0, 0)
        sync()
        step_s = time.time() - t0
        p_ref = one_process_step(s6, target, p0, seed=0)
        worst = params_agreement(p_sh, p_ref, "16a train step")
        moved = float((p_sh["diffuse"] - p0["diffuse"]).abs().max())
        require(moved > 0, "16a: the train step moved no parameter")
        log(f"16a train step (depth 16, diffuse [M, 3]): {step_s:.2f}s, loss "
            f"{float(loss):.6g}, parameters within {worst:.3g} relative of "
            f"the one-process step (moved up to {moved:.3g})")
        # the small furball at world size 1, for 16b
        sg = gloo_scene(device, small)
        img1 = pmesh.render_sharded(sg, mesh, spp=1, seed=0)
        p1, _ = pmesh.make_train_step(sg, mesh, torch.zeros_like(img1),
                                      spp=1, lr=SHARD_LR)(
            {"diffuse": sg.arrays.materials.diffuse}, 0)
        facts.update(wave_s=secs, allreduce_ms=ar_ms, step_s=step_s,
                     launches=launches)
    finally:
        dist.destroy_process_group()

    # 16b: two gloo ranks sharing the card
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="hairpt_gloo_") as tmp:
        gport = _free_port()

        def rank(r):
            return subprocess.run(
                [sys.executable, here, "--gloo-rank", str(r), "2",
                 str(gport), tmp, device] + [str(x) for x in small],
                cwd=os.path.dirname(here),
                capture_output=True, text=True, timeout=GLOO_TIMEOUT)
        t0 = time.time()
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(rank, r) for r in range(2)]
            if between is not None:
                between()
            procs = [f.result() for f in futs]
        wall = time.time() - t0
        for r, pr in enumerate(procs):
            require(pr.returncode == 0, f"16b rank {r} exited "
                    f"{pr.returncode}:\n{pr.stderr[-3000:]}")
        ranks = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(2)]
        outs = []
        for r, z in enumerate(ranks):
            outs.append(image_agreement(torch.as_tensor(z["img"]), img1,
                                        f"16b rank {r}"))
            params_agreement({"diffuse": torch.as_tensor(z["diffuse"])}, p1,
                             f"16b rank {r} train step")
        log(f"16b two gloo ranks on the {device} ({small[1]}^2 furball, "
            f"{int(6000 * small[0])} fibers, depth {small[2]}): "
            f"{wall:.1f}s wall{' beside phase 10' if between else ''}; "
            f"images against world size 1 {outs}; the "
            f"train step's parameters within {SHARD_PARAM_RTOL} on both "
            f"ranks")
    facts["gloo_wall_s"] = wall
    return facts


def materials_builder(res=1024, device="cuda", quality=HAIR_QUALITY,
                      hair=True):
    """Phase 16c's twin of the materials stand-in
    (scene_xmls.materials) through SceneBuilder with the rows the loader
    reads: each sphere's BSDF (a wrapper's nested rows first), the fur,
    the floor's checkerboard diffuse; the spheres and the floor in
    document order; the thin lens focused at FOCUS_DISTANCE."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import emitters as em
    from hairpt_torch.models import sensors
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.scene import furball, hairgen, scene_xmls
    from hairpt_torch.scene.scene import SceneBuilder

    bk7 = 1.5046 / 1.000277
    presets = {"Au": (0.40, (2.82, 2.35, 1.77)), "Cu": (0.95, (3.9, 2.45,
                                                               2.14)),
               "Ag": (0.14, (4.16, 3.44, 2.56)), "Al": (1.35, (7.47, 6.40,
                                                               5.30))}

    def cond(kind, name, **kw):
        return dict(kind=kind, twosided=False, eta=presets[name][0],
                    k=presets[name][1], dist=0, **kw)

    def plain(kind, **kw):
        row = dict(kind=kind, twosided=False, eta=1.5046, dist=0)
        row.update(kw)
        return row

    b = SceneBuilder(device=device)
    ids = []
    ids.append(b.add_material(**plain(mat.ROUGHDIFFUSE,
                                      diffuse=(0.6, 0.5, 0.4), alpha=0.5)))
    ids.append(b.add_material(**cond(mat.CONDUCTOR, "Au")))
    ids.append(b.add_material(**cond(mat.ROUGHCONDUCTOR, "Cu", alpha=0.2)))
    ids.append(b.add_material(**plain(mat.DIELECTRIC, eta=bk7)))
    ids.append(b.add_material(**plain(mat.THINDIELECTRIC, eta=bk7)))
    ids.append(b.add_material(**plain(mat.ROUGHDIELECTRIC, eta=bk7,
                                      alpha=0.1, dist=1)))
    ids.append(b.add_material(**plain(mat.DIFFTRANS)))
    ids.append(b.add_material(**plain(mat.PHONG, diffuse=(0.3, 0.05, 0.05),
                                      specular=(0.4, 0.4, 0.4),
                                      exponent=40.0)))
    ids.append(b.add_material(**plain(mat.WARD, diffuse=(0.05, 0.2, 0.3),
                                      specular=(0.3, 0.3, 0.3), alpha=0.15)))
    ids.append(b.add_material(**plain(mat.NULL)))
    a = b.add_material(**cond(mat.CONDUCTOR, "Ag"))
    c = b.add_material(**plain(mat.DIFFUSE, diffuse=(0.2, 0.5, 0.2)))
    ids.append(b.add_material(kind=mat.MIXTURE, twosided=False, mix_a=a,
                              mix_b=c, mix_w=0.3))
    a = b.add_material(**plain(mat.DIFFUSE, diffuse=(0.7, 0.7, 0.2)))
    ids.append(b.add_material(kind=mat.MASK, twosided=False, mix_a=a,
                              diffuse=(0.5, 0.5, 0.5)))
    a = b.add_material(**cond(mat.ROUGHCONDUCTOR, "Al", alpha=0.1))
    ids.append(b.add_material(
        kind=mat.COATING, twosided=False, mix_a=a, eta=bk7,
        sigma_a=tuple(np.asarray((0.1, 0.2, 0.4), np.float32) * 1.0),
        alpha=0.1, dist=0, specular=(1.0, 1.0, 1.0)))
    a = b.add_material(**plain(mat.DIFFUSE, diffuse=(0.1, 0.3, 0.6)))
    ids.append(b.add_material(
        kind=mat.ROUGHCOATING, twosided=False, mix_a=a, eta=bk7,
        sigma_a=tuple(np.asarray((0.0, 0.0, 0.0), np.float32) * 1.0),
        alpha=0.1, dist=0, specular=(1.0, 1.0, 1.0)))
    if hair:
        m = b.add_material(kind=mat.ROUGHPLASTIC, twosided=False,
                           eta=1.55 / 1.000277, diffuse=furball.DIFFUSE,
                           alpha=0.2, dist=0)
        radius = 0.00216667 / np.sqrt(min(max(quality, 1e-6), 1.0))
        b.add_fibers(hairgen.gen_furball(n_fibers=int(6000 * quality),
                                         radius=radius), m)
    for mid, cen in zip(ids, scene_xmls.material_centers()):
        t = np.eye(4)
        t[:3, 3] += np.asarray([float(x) for x in cen])
        b.add_mesh(shp.sphere(scene_xmls.PROP_RADIUS), mid, to_world=t)
    tid = b.add_checkerboard(color0=np.asarray((0.4,) * 3) * 1.0,
                             color1=np.asarray((0.2,) * 3) * 1.0,
                             uscale=8.0, vscale=8.0, uoffset=0.0,
                             voffset=0.0)
    floor = b.add_material(**plain(mat.DIFFUSE, tex_id=tid))
    s = np.eye(4)
    s[0, 0] = s[1, 1] = s[2, 2] = 20.0
    tr = np.eye(4)
    tr[:3, 3] = (0.0, 6.0, 0.0)
    b.add_mesh(shp.rectangle(), floor, to_world=tr @ (_rot((1, 0, 0), -90)
                                                      @ s))
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, device=b.device)
    cam = sensors.Camera.perspective(
        furball.CAM_TO_WORLD, 35.0, res, res, kind=sensors.THINLENS,
        aperture_radius=0.02, focus_distance=scene_xmls.FOCUS_DISTANCE)
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, int(np.ceil(np.log2(res))), res))


def materials_cell(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
                   small_res=64, small_quality=0.1, also=None):
    """Phase 16c: the materials stand-in (scene_xmls.materials: the XML
    furball ringed by one sphere per surface BSDF and wrapper material,
    a checkerboard floor, the sunsky, a thin lens). The CLI at
    min(res, CLI_WIDTH)^2, hair quality min(quality, CLI_HAIR_QUALITY),
    depth 65, 1 spp: exit
    0, four outputs, a finite positive mean. In process: load_scene
    against materials_builder (config and every tensor equal), one
    warm-up and one timed 1-spp wave (s/wave, rays/wave, Mrays/s, A, B and F
    launches, no plain version on the card). At small_res (hair quality
    small_quality, depth 8): the render card against CPU (MEAN_RTOL),
    the diffuse gradient card against CPU (3b's bounds), PRB against the
    differentiable mode on the card at depth 3. also: callable(scene) run
    on the loaded cell after its timed wave on the card, its result under
    "also" (phase 20a's MLT). Returns the in-process facts (None on the
    CPU, where a small res and quality rehearse it)."""
    import tempfile
    tmp_dir = tempfile.TemporaryDirectory(prefix="hairpt_materials_")
    try:
        return _materials_cell(reset_all, device, res, quality, small_res,
                               small_quality, tmp_dir.name, also)
    finally:
        tmp_dir.cleanup()


def _materials_cell(reset_all, device, res, quality, small_res,
                    small_quality, tmp, also=None):
    import numpy as np
    import torch
    from hairpt_torch.integrators import inverse, path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    xml = scene_xmls.write_scene(tmp, "materials", res=res)
    xml_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "materials",
                                   res=small_res)
    cw = min(res, CLI_WIDTH)
    cli_h = _cli_start(
        xml, os.path.join(tmp, "out", "materials.png"), quality, device,
        spp=1, res_scale=cw / res)
    t0 = time.time()
    scene = load_scene(xml, hair_quality=quality, spp_override=1,
                       device=device)
    t_load = time.time() - t0
    scene_b = materials_builder(res, device, quality)
    require(scene.config == scene_b.config
            and scene.active_kinds == scene_b.active_kinds
            and all(np.array_equal(x, y) for x, y in
                    zip(scene.camera, scene_b.camera)),
            f"config, camera or kinds differ: {scene.config} "
            f"{scene_b.config} {scene.camera} {scene_b.camera}")
    pairs = list(zip(_scene_tensors(scene.arrays),
                     _scene_tensors(scene_b.arrays)))
    require(len(pairs) > 10 and all(
        pa == pb and _same_bits(x, y) for (pa, x), (pb, y) in pairs),
        "the materials XML's arrays differ from the builder's: "
        + str([pa for (pa, x), (pb, y) in pairs if pa != pb
               or not _same_bits(x, y)]))
    del scene_b
    wall, t_build, t_render, img = _cli_wait(cli_h)
    require(img.shape == (cw, cw, 3) and np.isfinite(img).all()
            and img.mean() > 0, f"materials CLI image {img.shape}, mean "
            f"{img.mean()}")
    log(f"CLI materials ({cw}^2, hair quality "
        f"{min(quality, CLI_HAIR_QUALITY)}, depth 65, 1 spp): "
        f"exit 0 in {wall:.1f}s wall beside the scene load, scene built "
        f"in {t_build}s, rendered in {t_render}s; image mean "
        f"{img.mean():.6f}; four outputs")
    a = scene.arrays
    log(f"materials: loaded in {t_load:.1f}s, {len(pairs)} tensors equal to "
        f"SceneBuilder's; {a.hair.p0.shape[0]} segments, "
        f"{a.tri.p0.shape[0]} triangles, {a.materials.kind.shape[0]} material "
        f"rows, kinds {scene.active_kinds}, camera kind {scene.camera.kind} "
        f"(aperture {scene.camera.aperture_radius}, focus "
        f"{scene.camera.focus_distance:.4f})")
    facts = None
    if device == "cuda":
        progress, times, rays, n_timed = warm_up(scene, "materials",
                                                 max_timed=1)
        reset_all()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.synchronize()
        img = path.render(scene, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES, **ipk.LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
        queries = itiled.STATS["queries"] / n_timed
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        mean = float(img.mean())
        log(f"materials render: {n_timed} timed waves of 1 spp at {res}^2, "
            f"depth 65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s, {queries:.1f} tiled "
            f"queries/wave; image mean {mean:.6f}; launches over the timed "
            f"waves {launches}")
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"materials render: image mean {mean}")
        require(launches["cull_phase_a"] > 0 and launches["phase_b"] > 0
                and launches["packed_tri_closest"] > 0
                and launches["packed_tri_any"] > 0,
                f"the materials render did not launch A, B and F: "
                f"{launches}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
        facts = dict(secs=secs, rays=rays_w, n_timed=n_timed,
                     queries=queries, launches=launches)
        del img
        if also is not None:
            facts["also"] = also(scene)
    del scene

    devs = ("cuda", "cpu") if device == "cuda" else ("cpu",)
    means, grads = {}, {}
    for dev in devs:
        s = load_scene(xml_s, hair_quality=small_quality, spp_override=1,
                       max_depth_override=8, device=dev)
        means[dev] = float(path.render(s, spp=1).mean())
        grads[dev] = scan_ad_grad(s, {"diffuse": s.arrays.materials.diffuse})
    if device == "cuda":
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        (l_k, g_k, _), (l_p, g_p, _) = grads["cuda"], grads["cpu"]
        scale = float(g_p["diffuse"].abs().max())
        err = float((g_k["diffuse"].cpu() - g_p["diffuse"]).abs().max())
        lrel = abs(l_k - l_p) / max(abs(l_p), 1e-12)
        log(f"small materials ({small_res}^2, hair quality {small_quality}, "
            f"depth 8): image mean card {means['cuda']:.6f}, CPU "
            f"{means['cpu']:.6f}, rel diff {rel:.3g}; diffuse gradient loss "
            f"rel diff {lrel:.3g}, largest gradient diff {err:.3g} = "
            f"{err / scale:.3g} of the largest |g| ({scale:.4g})")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small materials render: card and CPU differ by {rel}")
        require(lrel <= GRAD_LOSS_RTOL and err <= GRAD_REL * scale,
                f"small materials gradient: card and CPU differ (loss "
                f"{lrel}, gradient {err / scale} of the largest)")
    s = load_scene(xml_s, hair_quality=small_quality, spp_override=1,
                   max_depth_override=3, device=devs[0])
    s = with_config(s, rr_depth=999)
    params = {"diffuse": s.arrays.materials.diffuse}
    l_s, g_s, _ = scan_ad_grad(s, params)
    n = s.config.width * s.config.height
    pix = torch.arange(n, device=s.arrays.device)
    l_r, g_r = inverse.make_prb_loss_grad(s)(s.arrays, params, pix,
                                             torch.zeros_like(pix))
    prel = float((g_r["diffuse"] - g_s["diffuse"]).abs().max()
                 / g_s["diffuse"].abs().max().clamp(min=1e-12))
    lrel = abs(float(l_r) - l_s) / max(abs(l_s), 1e-12)
    log(f"small materials, PRB vs the differentiable mode on {devs[0]}, "
        f"depth 3: loss {float(l_r):.6f} / {l_s:.6f} (rel {lrel:.3g}), "
        f"diffuse gradient diff over its largest |g| {prel:.3g}")
    require(lrel <= PRB_LOSS_RTOL and prel <= PRB_REL,
            f"small materials: PRB differs from the differentiable mode "
            f"(loss {lrel}, gradient {prel})")
    return facts


# 16d: each sensor kind but the perspective one, on the small materials
# stand-in (32^2, hair quality 0.1, depth 4), card against CPU
SENSOR_RES, SENSOR_QUALITY, SENSOR_DEPTH = 32, 0.1, 4


def sensor_kinds(device="cuda"):
    """Phase 16d: the small materials stand-in seen through each other
    sensor kind (thin lens, orthographic, spherical, telecentric, the
    radiance, fluence and irradiance meters, perspective_rdist with kc =
    (0.12, -0.03)), the image means card against CPU within MEAN_RTOL.
    The radiance meter, whose every sample looks along the camera's axis
    (into the furball's dark core), is aimed from the camera's origin at
    the first sphere. Returns {kind name: (card mean, CPU mean)}."""
    import tempfile
    import numpy as np
    from hairpt_torch.core.math import matrix_lookat
    from hairpt_torch.integrators import path
    from hairpt_torch.models import sensors
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    kinds = {"thinlens": sensors.THINLENS,
             "orthographic": sensors.ORTHOGRAPHIC,
             "spherical": sensors.SPHERICAL,
             "telecentric": sensors.TELECENTRIC,
             "radiancemeter": sensors.RADIANCEMETER,
             "fluencemeter": sensors.FLUENCEMETER,
             "irradiancemeter": sensors.IRRADIANCEMETER,
             "perspective_rdist": sensors.PERSPECTIVE_RDIST}
    devs = (device, "cpu") if device == "cuda" else ("cpu",)
    with tempfile.TemporaryDirectory(prefix="hairpt_sensors_") as tmp:
        xml = scene_xmls.write_scene(tmp, "materials", res=SENSOR_RES,
                                     aperture=0.05)
        scenes = {d: load_scene(xml, hair_quality=SENSOR_QUALITY,
                                spp_override=1,
                                max_depth_override=SENSOR_DEPTH, device=d)
                  for d in devs}
    out = {}
    for name, kind in kinds.items():
        means = {}
        for d, s in scenes.items():
            cam = s.camera._replace(kind=kind)
            if name == "perspective_rdist":
                cam = cam._replace(kc0=0.12, kc1=-0.03)
            if name == "radiancemeter":
                eye = s.camera.to_world[:3, 3].astype(np.float64)
                cam = cam._replace(to_world=matrix_lookat(
                    eye, scene_xmls.material_centers()[0],
                    (0.0, 1.0, 0.0)).astype(np.float32))
            img = path.render(s._replace(camera=cam), spp=1)
            require(bool(img.isfinite().all()), f"16d {name} on {d}: "
                    f"non-finite pixels")
            means[d] = float(img.mean())
        out[name] = tuple(means.get(d) for d in ("cuda", "cpu"))
        if device == "cuda":
            rel = abs(means["cuda"] - means["cpu"]) \
                / max(abs(means["cpu"]), 1e-12)
            require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                    f"16d {name}: card {means['cuda']} and CPU "
                    f"{means['cpu']} differ by {rel}")
    return out


# ---------------------------------------------------------------------------
# phase 17: participating media (volpath, kernel J) and subsurface
# scattering
# ---------------------------------------------------------------------------
# kernel J (csrc/woodcock.cu): f32 operations per lane (the box clip: per
# axis a compare, a division, 2 subtractions, 2 products, a min and a max;
# 4 across the axes: 28) and per step of the dense lookup (the step 3, the
# point 6, the grid coordinates 6 and their 6 compares, the node
# coordinates 3, 3 floors, 3 subtractions and 6 clamps, the 3 weights' 1 -
# w, 7 lerps of 3, sigma and the tests 4: 66; the block-sparse lookup's
# node coordinates are per axis a product, two clamps, a division and a
# subtraction: 78), counted from the source; bytes: 44 B per lane in (o,
# d, t_max, pixel, sample), 5 B (delta tracking) or 12 B (ratio tracking)
# out, and each grid voxel (and block-table entry) that the steps taken
# read, once (j_grid_bytes)
J_LANE_FLOPS = 28
J_STEP_FLOPS = {"dense": 66, "hgrid": 78}
J_REPLACES = {"woodcock_sample": "hairpt/models/media.py:761",
              "woodcock_transmittance": "hairpt/models/media.py:797"}
#  kernel J against its plain version: t, is_med and tr bit for bit
#  (the same float32 operations in the same order, no contraction, and
#  CUDA's logf in both); the bound stated if they are not: is_med equal
#  on >= J_FLAG_SHARE of the lanes, t and tr within J_MAX_ULPS where the
#  flags agree
J_FLAG_SHARE = 0.9999
J_MAX_ULPS = 4
# 17b-d: the renders card against CPU at 64^2 (the teapot stand-ins at
# 64 x 36), hair quality 0.1, depth 8, a 64^3 smoke; MEAN_RTOL
SMALL17 = dict(res=64, quality=0.1, depth=8, vol_res=64)


def _ulps(a, b):
    """|a - b| in float32 units in the last place, per element."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def media_builder(res, device, quality, vol_path):
    """Phase 17b's twin of the media stand-in (scene_xmls.media) through
    SceneBuilder with the values the loader reads: phase 11's furball under
    its rough plastic, the sunsky, the smoke grid (load_vol) as a
    heterogeneous medium of sigmaS 0.5, sigmaA 0.05 and HG g 0.3, the
    volpath integrator."""
    import numpy as np
    from hairpt_torch.core import rng
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import emitters as em
    from hairpt_torch.models import media
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene import furball, hairgen
    from hairpt_torch.scene.scene import SceneBuilder

    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.ROUGHPLASTIC, twosided=False,
                       eta=1.55 / 1.000277, diffuse=furball.DIFFUSE,
                       alpha=0.2, dist=0)
    radius = 0.00216667 / np.sqrt(min(max(quality, 1e-6), 1.0))
    b.add_fibers(hairgen.gen_furball(n_fibers=int(6000 * quality),
                                     radius=radius), m)
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, device=b.device)
    b.medium = media.make_hetero_medium(
        media.load_vol(vol_path, device=b.device), (0.5,) * 3, (0.05,) * 3,
        g=0.3, phase_kind=media.HG)
    cam = Camera.perspective(furball.CAM_TO_WORLD, 35.0, res, res)
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=65,
                   sampler=(rng.SOBOL_QMC, int(np.ceil(np.log2(res))), res),
                   integrator="volpath")


def j_grid_bytes(vol, points):
    """The bytes of the grid that lookups at `points` (a list of [M, 3]
    tensors: the steps taken) read, each voxel once: the 8 corners of
    every lookup inside the grid box (media.grid_density /
    hgrid_density's index arithmetic), and for a block-sparse volume the
    block-table entry of each lookup too."""
    import torch
    from hairpt_torch.models import media

    if not points:
        return 0
    p = torch.cat(points)
    g = (p - vol.world_min) * vol.inv_extent
    g = g[((g >= 0.0) & (g <= 1.0)).all(-1)]

    def corners(f, n, base=0):
        # the flat index of each lookup's 8 corners in an [n2, n1, n0]
        # array (f [M, 3] node coordinates x, y, z)
        i0 = [torch.clamp(torch.floor(f[:, a]).long(), 0, n[a] - 2)
              for a in range(3)]
        return torch.cat([base + ((i0[2] + dz) * n[1] + i0[1] + dy) * n[0]
                          + i0[0] + dx for dz in (0, 1) for dy in (0, 1)
                          for dx in (0, 1)])
    if not isinstance(vol, media.HGridVolume):
        D, H, W = vol.data.shape
        f = g * torch.tensor([W - 1, H - 1, D - 1], device=g.device)
        return 4 * int(torch.unique(corners(f, (W, H, D))).numel())
    BZ, BY, BX = vol.block_idx.shape
    nb = vol.blocks.shape[1]
    top = torch.tensor([BX * nb - 1, BY * nb - 1, BZ * nb - 1],
                       device=g.device, dtype=torch.float32)
    f = torch.minimum(torch.clamp(g * top, min=0.0), top)
    c = torch.minimum((f / nb).long(),
                      torch.tensor([BX - 1, BY - 1, BZ - 1], device=g.device))
    tbl = (c[:, 2] * BY + c[:, 1]) * BX + c[:, 0]
    bi = vol.block_idx.reshape(-1)[tbl].long()
    keep = bi >= 0
    vox = corners(f[keep] - (c[keep] * nb).float(), (nb, nb, nb),
                  bi[keep] * nb ** 3)
    return 4 * int(torch.unique(tbl).numel() + torch.unique(vox).numel())


def hgrid_medium(med):
    """The heterogeneous medium with its dense grid made block-sparse
    (media.make_hgrid_from_dense: 8^3 blocks, the empty ones dropped), on
    the grid's device."""
    from hairpt_torch.models import media

    vol = med.vol
    wmin = vol.world_min.cpu().numpy()
    return med._replace(vol=media.make_hgrid_from_dense(
        vol.data.cpu().numpy(), wmin,
        wmin + 1.0 / vol.inv_extent.cpu().numpy(), device=vol.data.device))


def woodcock_waves(scene):
    """The media cell's Woodcock inputs (o, d, t_max, pixel, sample,
    dim_base) of its camera wave (lanes in pixel order, the sample-0
    camera rays, t_max the closest hit's t or 1e30) and of a first-bounce
    wave (from each camera lane's free-flight end: its medium event, else
    its surface hit lifted off the surface, uniformly random directions,
    t_max the closest hit's; lanes with neither at the camera)."""
    import numpy as np
    import torch
    from hairpt_torch.core import rng, warps
    from hairpt_torch.core.math import Ray
    from hairpt_torch.integrators import common, path, volpath
    from hairpt_torch.models import media

    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    med = scene.medium
    n = cfg.width * cfg.height
    pixel = torch.arange(n, device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    _, ray = volpath._camera(cfg, scene.camera, smp, n)
    params = path._swept_params(cfg)
    hit = common.scene_intersect(arr, ray, **params)
    t_max = torch.where(hit.valid, hit.t, 1e30)
    cam = (ray.o, ray.d, t_max, smp.pixel, smp.sample, path.DIM_BASE + 9)
    t, is_med = media.woodcock_sample(med, *cam)
    p = torch.where(is_med[:, None], ray.o + ray.d * t[:, None],
                    hit.p + hit.geo_n * cfg.ray_eps)
    live = is_med | hit.valid
    o2 = torch.where(live[:, None], p, ray.o)
    u = torch.as_tensor(np.random.default_rng(7).random((n, 2)),
                        dtype=torch.float32, device=dev)
    d2 = warps.square_to_uniform_sphere(u)
    hit2 = common.scene_intersect(
        arr, Ray(o=o2, d=d2, mint=torch.zeros(n, device=dev),
                 maxt=torch.full((n,), float("inf"), device=dev)),
        sort_rays=True, **params)
    bounce = (o2, d2, torch.where(hit2.valid, hit2.t, 1e30), smp.pixel,
              smp.sample, path.DIM_BASE + path.DIM_STRIDE + 9)
    return {"camera": cam, "bounce": bounce}


def check_kernel_j(label, med, wave, report):
    """Kernel J against its plain version on every lane of a wave, delta
    tracking (t, is_med) and ratio tracking (tr, over min(t_max, 1e6) as
    volpath's shadow rays) bit for bit, or to J_FLAG_SHARE / J_MAX_ULPS,
    through the medium's dense or block-sparse grid; each timed (CUDA
    events over 5 launches, the plain loop once) beside its bound (the
    inputs and the grid voxels that the steps taken read, once, the
    outputs written once, against the counted operations of the steps
    taken)."""
    import torch
    from hairpt_torch.models import media

    o, d, t_max, pix, smp, dim = wave
    n = o.shape[0]
    kind = "hgrid" if isinstance(med.vol, media.HGridVolume) else "dense"
    for name in ("woodcock_sample", "woodcock_transmittance"):
        ratio = name == "woodcock_transmittance"
        tm = torch.clamp(t_max, max=1e6) if ratio else t_max
        kern = getattr(media, name)
        plain = getattr(media, f"{name}_plain")
        counts = {"points": []}
        out_k = kern(med, o, d, tm, pix, smp, dim)
        out_p = plain(med, o, d, tm, pix, smp, dim, counts=counts)
        torch.cuda.synchronize()
        grid_bytes = j_grid_bytes(med.vol, counts.pop("points"))
        if ratio:
            same = (_ulps(out_k, out_p) == 0).all(-1)
            ulps = int(_ulps(out_k, out_p).max())
            flag_share = 1.0
            err = float((out_k - out_p).abs().max())
        else:
            (tk_, mk), (tp_, mp) = out_k, out_p
            agree = mk == mp
            flag_share = float(agree.float().mean())
            u = _ulps(tk_, tp_)[agree]
            ulps = int(u.max()) if u.numel() else 0
            same = agree & (_ulps(tk_, tp_) == 0)
            err = float((tk_ - tp_)[agree & mk].abs().max()) \
                if bool((agree & mk).any()) else 0.0
        exact = float(same.float().mean())
        log(f"  J {name} on the {label} wave ({kind} grid, {n} lanes, "
            f"{counts['steps']} steps, {grid_bytes} grid bytes read): "
            f"{exact:.6f} of the lanes bit for bit, flags "
            f"{flag_share:.6f} equal, largest diff {ulps} ulps "
            f"({err:.3g})" + ("" if ratio else f"; medium events "
                               f"{float(mk.float().mean()):.4f}"))
        require(flag_share >= J_FLAG_SHARE and ulps <= J_MAX_ULPS,
                f"kernel J ({name}, {label}) differs from its plain version: "
                f"flags {flag_share}, {ulps} ulps")
        ms = cuda_ms(lambda: kern(med, o, d, tm, pix, smp, dim), 5)
        plain_ms = cuda_ms(lambda: plain(med, o, d, tm, pix, smp, dim), 1,
                           warm=False)
        b_ms, by = bound_ms(n * (44 + (12 if ratio else 5)) + grid_bytes,
                            n * J_LANE_FLOPS
                            + counts["steps"] * J_STEP_FLOPS[kind])
        log(f"  J {name} ({label}, {kind}): {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {by} "
            f"({ms / b_ms:.1f}x)")
        report.setdefault(name, []).append((
            label if kind == "dense" else f"{label}, {kind}", dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                max_abs_err=err, ulps=ulps, exact_share=exact,
                steps=counts["steps"], lanes=n, grid_bytes=grid_bytes)))


def media_cell(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
               small=SMALL17):
    """Phase 17a/b: the media stand-in (scene_xmls.media: the XML furball
    in a 256^3 smoke grid, HG g 0.3, the sunsky, volpath). The CLI at
    CLI_WIDTH across and 2 spp (exit 0, four outputs, a finite positive
    mean); load_scene against media_builder (config, every tensor and the
    medium equal); 17a, kernel J against its plain version on the camera
    and first-bounce waves; a warm-up and two timed 1-spp waves (s/wave,
    Mrays/s, tiled queries per wave, A, B and J launches, no plain
    version on the card); the small stand-in card against CPU. Returns
    (the in-process facts, J's report) (None, None on the CPU, where
    small sizes rehearse it)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hairpt_media_") as tmp:
        return _media_cell(reset_all, device, res, quality, small, tmp)


def _media_cell(reset_all, device, res, quality, small, tmp):
    import numpy as np
    import torch
    from hairpt_torch.integrators import volpath
    from hairpt_torch.models import media
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    xml = scene_xmls.write_scene(tmp, "media", res=res)
    cw = min(res, CLI_WIDTH)
    cli_h = _cli_start(
        xml, os.path.join(tmp, "out", "media.png"), quality, device, spp=2,
        res_scale=cw / res)
    t0 = time.time()
    scene = load_scene(xml, hair_quality=quality, spp_override=1,
                       device=device)
    t_load = time.time() - t0
    scene_b = media_builder(res, device, quality,
                            os.path.join(os.path.dirname(xml), "smoke.vol"))
    pairs = list(zip(_scene_tensors(scene.arrays),
                     _scene_tensors(scene_b.arrays)))
    mpairs = list(zip(_scene_tensors(scene.medium, "medium"),
                      _scene_tensors(scene_b.medium, "medium")))
    require(scene.config == scene_b.config
            and scene.medium[5:] == scene_b.medium[5:],
            f"configs differ: {scene.config} {scene_b.config}")
    require(len(pairs) > 10 and len(mpairs) == 7 and all(
        pa == pb and _same_bits(x, y)
        for (pa, x), (pb, y) in pairs + mpairs),
        "the media XML's scene differs from the builder's: "
        + str([pa for (pa, x), (pb, y) in pairs + mpairs if pa != pb
               or not _same_bits(x, y)]))
    del scene_b
    wall, t_build, t_render, img = _cli_wait(cli_h)
    require(img.shape == (cw, cw, 3) and np.isfinite(img).all()
            and img.mean() > 0, f"media CLI image {img.shape}, mean "
            f"{img.mean()}")
    log(f"CLI media ({cw}^2, hair quality "
        f"{min(quality, CLI_HAIR_QUALITY)}, depth 65, 2 spp, "
        f"volpath): exit 0 in {wall:.1f}s wall beside the scene load, "
        f"scene built in {t_build}s, "
        f"rendered in {t_render}s; image mean {img.mean():.6f}")
    med = scene.medium
    log(f"media: loaded in {t_load:.1f}s, {len(pairs)} + {len(mpairs)} "
        f"tensors equal to SceneBuilder's; {scene.arrays.hair.p0.shape[0]} "
        f"segments; grid {tuple(med.vol.data.shape)} "
        f"({med.vol.data.numel() * 4 / 2**20:.0f} MiB), majorant "
        f"{float(med.majorant):.6f}, integrator {scene.config.integrator}")
    facts = report = None
    if device == "cuda":
        t0 = time.time()
        report = {}
        waves = woodcock_waves(scene)
        for m in (med, hgrid_medium(med)):
            for label, wave in waves.items():
                check_kernel_j(label, m, wave, report)
        hv = m.vol
        del waves, m
        log(f"phase 17a ({time.time() - t0:.1f}s): kernel J matches its "
            f"plain version on the media cell's camera and bounce waves, "
            f"through the dense grid and its block-sparse form "
            f"({hv.blocks.shape[0]} of {hv.block_idx.numel()} "
            f"{hv.blocks.shape[1]}^3 blocks kept)")
        del hv
        progress, times, rays, n_timed = warm_up(
            scene, "media", render=volpath.render_volpath)
        reset_all()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.synchronize()
        img = volpath.render_volpath(scene, spp=n_timed, seed=1,
                                     progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES, **media.LAUNCHES)
        plain = dict(tk.PLAIN_ON_CUDA, **media.PLAIN_ON_CUDA,
                     **ipk.PLAIN_ON_CUDA)
        queries = itiled.STATS["queries"] / n_timed
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        mean = float(img.mean())
        log(f"media render: {n_timed} timed waves of 1 spp at {res}^2, "
            f"depth 65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s, {queries:.1f} tiled "
            f"queries/wave; image mean {mean:.6f}; launches over the timed "
            f"waves {launches}")
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"media render: image mean {mean}")
        require(all(launches[k] > 0 for k in (
            "cull_phase_a", "phase_b", "woodcock_sample",
            "woodcock_transmittance")),
            f"the media render did not launch A, B and J: {launches}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
        facts = dict(secs=secs, rays=rays_w, n_timed=n_timed,
                     queries=queries, launches=launches)
        del img
    del scene, med
    xml_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "media",
                                   res=small["res"],
                                   vol_res=small["vol_res"])
    _card_vs_cpu("media", xml_s, device, small, volpath.render_volpath)
    j0, p0 = dict(media.LAUNCHES), dict(media.PLAIN_ON_CUDA)
    _card_vs_cpu("media, block-sparse grid", xml_s, device, small,
                 volpath.render_volpath,
                 prepass=lambda s: s._replace(medium=hgrid_medium(s.medium)))
    if device == "cuda":
        require(all(media.LAUNCHES[k] > j0[k] for k in j0)
                and media.PLAIN_ON_CUDA == p0,
                f"the block-sparse render's Woodcock walks did not run "
                f"through kernel J: {dict(media.LAUNCHES)}, "
                f"{dict(media.PLAIN_ON_CUDA)}")
    return facts, report


def _card_vs_cpu(label, xml, device, small, render, prepass=None,
                 **load_kw):
    """A small render of the XML on the card and with the plain versions
    on the CPU (hair quality small["quality"], depth small["depth"], 1
    spp): finite, positive, means within MEAN_RTOL."""
    from hairpt_torch.scene.xml_loader import load_scene
    devs = ("cuda", "cpu") if device == "cuda" else ("cpu",)
    means = {}
    for dev in devs:
        s = load_scene(xml, hair_quality=small["quality"], spp_override=1,
                       max_depth_override=small["depth"], device=dev,
                       **load_kw)
        if prepass is not None:
            s = prepass(s)
        img = render(s, spp=1)
        means[dev] = float(img.mean())
        require(bool(img.isfinite().all()) and means[dev] > 0,
                f"small {label} on {dev}: mean {means[dev]}")
    if device == "cuda":
        rel = abs(means["cuda"] - means["cpu"]) / means["cpu"]
        log(f"small {label} ({s.config.width} x {s.config.height}, depth "
            f"{small['depth']}): image mean card {means['cuda']:.6f}, CPU "
            f"{means['cpu']:.6f}, rel diff {rel:.3g}")
        require(rel <= MEAN_RTOL, f"small {label}: card and CPU differ by "
                f"{rel}")
    return means


def bounded_cell(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
                 small=SMALL17):
    """Phase 17c: the bounded-media stand-in (scene_xmls.bounded: the
    furball in a null-bounded fog sphere, a dielectric sphere with an
    interior medium, an hk sphere, a checkerboard floor, the sunsky;
    volpath, 1024^2, depth 65): a warm-up and two timed 1-spp waves
    (s/wave, each wave's seconds, Mrays/s, A, B and F launches); the small
    stand-in card against CPU. Returns the in-process facts (None on the
    CPU)."""
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.integrators import volpath
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    facts = None
    with tempfile.TemporaryDirectory(prefix="hairpt_bounded_") as tmp:
        xml = scene_xmls.write_scene(tmp, "bounded", res=res)
        xml_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "bounded",
                                       res=small["res"])
        if device == "cuda":
            scene = load_scene(xml, hair_quality=quality, spp_override=1,
                               device=device)
            a = scene.arrays
            log(f"bounded: {a.hair.p0.shape[0]} segments, "
                f"{a.tri.p0.shape[0]} triangles, media "
                f"{a.media.sigma_t.shape[0] - 1}, kinds {scene.active_kinds}")
            progress, times, rays, n_timed = warm_up(
                scene, "bounded", render=volpath.render_volpath)
            reset_all()
            itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
            torch.cuda.synchronize()
            img = volpath.render_volpath(scene, spp=n_timed, seed=1,
                                         progress=progress)
            torch.cuda.synchronize()
            launches = dict(tk.LAUNCHES, **ipk.LAUNCHES)
            plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
            secs = sum(times) / len(times)
            rays_w = sum(rays) / len(rays)
            mean = float(img.mean())
            queries = itiled.STATS["queries"] / n_timed
            log(f"bounded render: {n_timed} timed waves of 1 spp at {res}^2, "
                f"depth 65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave ("
                f"{', '.join(f'{x:.3f}' for x in times)} s), "
                f"{rays_w / secs / 1e6:.4f} Mrays/s, {queries:.1f} tiled "
                f"queries/wave; image mean {mean:.6f}; launches {launches}")
            require(np.isfinite(mean) and mean > 0
                    and bool(torch.isfinite(img).all()),
                    f"bounded render: image mean {mean}")
            require(launches["cull_phase_a"] > 0 and launches["phase_b"] > 0
                    and launches["packed_tri_closest"] > 0,
                    f"the bounded render did not launch A, B and F: "
                    f"{launches}")
            require(all(v == 0 for v in plain.values()),
                    f"plain versions ran on CUDA tensors: {plain}")
            facts = dict(secs=secs, rays=rays_w, n_timed=n_timed,
                         queries=queries, launches=launches, times=times)
            del scene, img
        _card_vs_cpu("bounded", xml_s, device, small,
                     volpath.render_volpath)
    return facts


def subsurface_cell(reset_all, device="cuda", small=SMALL17):
    """Phase 17d: the subsurface stand-ins (scene_xmls.subsurface: the
    teapot stand-in under a dipole and under single scattering, path):
    the dipole's irradiance prepass at 1280 x 720 (its seconds, F's any
    hit launched), then each at 64 x 36 card against CPU (the prepass
    on each device before the render). Returns the prepass seconds (None
    on the CPU)."""
    import tempfile
    import torch
    from hairpt_torch.integrators import path, sss
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    secs = None
    with tempfile.TemporaryDirectory(prefix="hairpt_sss_") as tmp:
        for kind in ("dipole", "singlescatter"):
            xml = scene_xmls.write_scene(tmp, kind)
            if device == "cuda" and kind == "dipole":
                scene = load_scene(xml, spp_override=1, device=device)
                reset_all()
                torch.cuda.synchronize()
                t0 = time.time()
                scene = sss.attach_dipole(scene)
                torch.cuda.synchronize()
                secs = time.time() - t0
                s = scene.arrays.sss
                log(f"dipole prepass at {TEAPOT_RES[0]} x {TEAPOT_RES[1]}: "
                    f"{secs:.3f} s for {s.pos.shape[0]} points x 16 light "
                    f"samples, mean irradiance {float(s.irr.mean()):.6f}; F "
                    f"launches {dict(ipk.LAUNCHES)}")
                require(ipk.LAUNCHES["packed_tri_any"] > 0
                        and bool(s.irr.isfinite().all()),
                        "the dipole prepass did not run through kernel F")
                del scene, s
            _card_vs_cpu(kind, xml, device, small, path.render,
                         prepass=sss.attach_dipole,
                         res_scale=small["res"] / TEAPOT_RES[0])
    return secs


def j_kernel_entries(report, launches, n_timed):
    """The kernels line's entries for kernel J: its time on the camera
    wave through the dense grid, its launches over the media cell's timed
    waves, and under other_waves its times on the first-bounce wave and
    on both waves through the block-sparse grid."""
    entries = []
    for name, rows in sorted(report.items()):
        label, f = rows[0]
        entries.append(dict(
            name=name, route="cuda", source="hairpt_torch/csrc/woodcock.cu",
            replaces=J_REPLACES[name], launches=launches[name],
            max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
            bound_ms=f["bound_ms"], bound_by=f["bound_by"], library_ms=None,
            timed_on=label, launched_by="the media cell's timed waves "
            "(phase 17b)", launches_per_wave=launches[name] / n_timed,
            ulps=f["ulps"], steps=f["steps"],
            grid_bytes=f["grid_bytes"],
            other_waves={lb: dict(ms=x["ms"], plain_ms=x["plain_ms"],
                                  bound_ms=x["bound_ms"],
                                  bound_by=x["bound_by"], ulps=x["ulps"],
                                  max_abs_err=x["max_abs_err"],
                                  steps=x["steps"],
                                  grid_bytes=x["grid_bytes"])
                         for lb, x in rows[1:]}))
    return entries


# ---------------------------------------------------------------------------
# phase 18: the light tracers (ptracer, bdpt, vpl) and the photon maps
# (photonmapper / ppm, sppm, the beam radiance estimate) through kernels
# A, B, F and kernel K (csrc/photons.cu, the hash-grid photon query)
# ---------------------------------------------------------------------------

K_REPLACES = {"photon_surface": "hairpt/integrators/photonmap.py:214",
              "photon_beam": "hairpt/integrators/photonmap.py:441"}
# K's operations, counted from photons.cu: per in-grid cell its key (6
# integer operations) and a binary search of ceil(log2(M + 1)) probes (4
# each: the midpoint, a load, a compare, a select); per slot read the
# clamp, the key compare and the validity (3) and the distance test
# (surface: 3 subtractions, 3 products, 2 sums, a compare = 9; beam: the
# foot and |rel|^2 (3 subtractions, 6 products, 4 sums), b^2 (2), r^2
# (1) and five compares = 21); per beam step its bounds, t_mid, the
# point and its cell (16)
K_CELL_OPS = 6
K_PROBE_OPS = 4
K_SLOT_OPS = {"photon_surface": 12, "photon_beam": 24}
K_STEP_OPS = 16
# the photon maps of 18a: the ppm pass's radius and photon count of the
# lit cell (hairpt's render_photonmap defaults: 1 << 16 photons, 4
# bounces), the fog cell's volumetric map at its defaults (1 << 15
# photons, radius 0.25, 8 bounces); the beam check's lanes
K_SURFACE = dict(n_photons=1 << 16, bounces=4, radius=0.3)
K_BEAM = dict(n_photons=1 << 15, bounces=8, radius=0.25)
K_BEAM_LANES = 1 << 18
SMALL18 = dict(res=64, quality=0.1, depth=8)
LIGHT_TRACERS = ("ptracer", "bdpt", "vpl", "ppm", "sppm")


def k_bound(name, counts, n_lanes, M, n_pairs):
    """(bound ms, 'bytes' or 'operations') of one photon query: the lane
    inputs, the sorted keys and the photon rows read once and the pairs
    written once, against the operations of the plain version's counted
    cells, slots and steps."""
    import math
    beam = name == "photon_beam"
    n_bytes = n_lanes * (28 if beam else 16) + M * (21 if beam else 17) \
        + n_pairs * (12 if beam else 8)
    probes = math.ceil(math.log2(M + 1))
    ops = counts["cells"] * (K_CELL_OPS + probes * K_PROBE_OPS) \
        + counts["slots"] * K_SLOT_OPS[name] \
        + counts.get("steps", 0) * K_STEP_OPS
    return bound_ms(n_bytes, ops)


def check_kernel_k(name, grid, lanes, report, n_steps=0, label=""):
    """Kernel K against its plain version on the card on `lanes` (surface:
    p, r2; beam: o, d, t_end): the pair lists (lane, photon and, in beam
    mode, step * 27 + cell) equal; K timed by CUDA events over 5 calls
    (two launches each), the plain version once, the bound."""
    import torch
    from hairpt_torch.ops import photon_query as pq
    beam = name == "photon_beam"
    counts = {}
    if beam:
        got = pq.beam_pairs(grid, *lanes, n_steps)
        want = pq.beam_pairs_plain(grid, *lanes, n_steps, counts=counts)
    else:
        got = pq.surface_pairs(grid, *lanes)
        want = pq.surface_pairs_plain(grid, *lanes, counts=counts)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{name} ({label}): kernel K's pairs differ from the plain "
            f"version's: {[int(a.numel()) for a in got]} against "
            f"{[int(b.numel()) for b in want]}")
    n = lanes[0].shape[0]
    P = int(got[0].numel())
    if beam:
        k_ms = cuda_ms(lambda: pq.beam_pairs(grid, *lanes, n_steps), 5)
        p_ms = cuda_ms(lambda: pq.beam_pairs_plain(grid, *lanes, n_steps),
                       1, warm=False)
    else:
        k_ms = cuda_ms(lambda: pq.surface_pairs(grid, *lanes), 5)
        p_ms = cuda_ms(lambda: pq.surface_pairs_plain(grid, *lanes), 1,
                       warm=False)
    b_ms, by = k_bound(name, counts, n, grid.M, P)
    report[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                        max_abs_err=0.0, pairs=P, lanes=n,
                        pairs_per_lane=P / max(n, 1), photons=grid.M,
                        cells=counts["cells"], slots=counts["slots"],
                        steps=counts.get("steps"), label=label)
    log(f"K {name} ({label}): {n} lanes, {grid.M} photons, {P} pairs "
        f"({P / max(n, 1):.3f} per lane), {counts} equal bit for bit; "
        f"{k_ms:.3f} ms (plain {p_ms:.1f} ms), bound {b_ms:.4f} ms by {by} "
        f"({k_ms / max(b_ms, 1e-12):.1f}x)")


def _timed_light(name, scene, reset_all):
    """One timed wave or pass of a light tracer on `scene` (the small
    card-against-CPU render before it is the warm-up): (s per wave, waves,
    the launches of A, B, F and K, tiled queries per wave, the image)."""
    import torch
    from hairpt_torch.integrators import bdpt, photonmap, ptracer, vpl
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import photon_query as pq
    from hairpt_torch.ops import tiled_kernels as tk
    times = []

    def progress(done, total, secs, n):
        times.append(secs)
    run = {"ptracer": lambda: ptracer.render_ptracer(scene,
                                                     progress=progress),
           "bdpt": lambda: bdpt.render_bdpt(scene, spp=1, progress=progress),
           "vpl": lambda: vpl.render_vpl(scene, spp=1, progress=progress),
           "ppm": lambda: photonmap.render_ppm(scene, passes=1,
                                               progress=progress),
           "sppm": lambda: photonmap.render_sppm(scene, passes=1,
                                                 progress=progress),
           "fog": lambda: photonmap.render_volumetric_photonmap(
               scene, spp=1, progress=progress)}[name]
    reset_all()
    itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
    torch.cuda.synchronize()
    t0 = time.time()
    img = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(tk.LAUNCHES, **ipk.LAUNCHES, **pq.LAUNCHES)
    plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA, **pq.PLAIN_ON_CUDA)
    n = max(len(times), 1)
    require(all(v == 0 for v in plain.values()),
            f"{name}: plain versions ran on CUDA tensors: {plain}")
    return dict(secs=wall / n, wall=wall, waves=n, launches=launches,
                queries=itiled.STATS["queries"] / n, img=img)


def _small_light(name, xml, device, small):
    """The light tracer's small render card against CPU (fewer photons and
    paths than at full width: the CPU's plain versions are slow)."""
    from hairpt_torch.integrators import bdpt, photonmap, ptracer, vpl
    render = {
        "ptracer": lambda s, spp: ptracer.render_ptracer(s, n_paths=1 << 12,
                                                          s_max=4),
        "bdpt": lambda s, spp: bdpt.render_bdpt(s, spp=spp),
        "vpl": lambda s, spp: vpl.render_vpl(s, n_paths=32, spp=spp),
        "ppm": lambda s, spp: photonmap.render_ppm(s, n_photons=1 << 12,
                                                   passes=2, spp=spp),
        "sppm": lambda s, spp: photonmap.render_sppm(s, n_photons=1 << 12,
                                                     passes=2),
        "fog": lambda s, spp: photonmap.render_volumetric_photonmap(
            s, n_photons=1 << 12, spp=spp)}[name]
    return _card_vs_cpu(f"{name}", xml, device, small, render)


def light_cells(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
                small=SMALL18):
    """Phase 18: the light tracers and the photon maps. 18a kernel K
    against its plain version (surface: every lane of the lit cell's
    camera wave against a photon map of 1 << 16 photons; beam:
    K_BEAM_LANES lanes of the fog cell's camera wave); 18b each of
    ptracer, bdpt, vpl, ppm and sppm on the lit stand-in at res^2 (one
    timed wave or pass after its small render card against CPU, the
    warm-up); 18c the fog stand-in's volumetric photon map (one timed
    wave; its small render card against CPU); 18d the CLI on the lit XML
    with --integrator bdpt and on the fog XML with its photonmapper, at
    CLI_WIDTH across and 1 spp. Returns (facts, K's report) (the report
    None on the CPU, where small sizes rehearse it)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hairpt_light_") as tmp:
        return _light_cells(reset_all, device, res, quality, small, tmp)


def _light_cells(reset_all, device, res, quality, small, tmp):
    import math
    import numpy as np
    import torch
    from hairpt_torch.integrators import photonmap
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene

    facts = {}
    report = {} if device == "cuda" else None
    lit_xml = scene_xmls.write_scene(tmp, "lit", res=res)
    fog_xml = scene_xmls.write_scene(tmp, "fog", res=res)
    lit_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "lit",
                                   res=small["res"])
    fog_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "fog",
                                   res=small["res"])
    # 18d's CLIs run beside the small renders (card against CPU), which
    # are also each timed run's warm-up
    t1 = time.time()
    cw = min(res, CLI_WIDTH)
    clis = [(label, _cli_start(
        xml, os.path.join(tmp, "out", label.split(",")[0] + ".png"),
        quality, device, spp=1, res_scale=cw / res, extra=extra))
        for label, xml, extra in (("lit, bdpt", lit_xml,
                                   ["--integrator", "bdpt"]),
                                  ("fog, photonmapper", fog_xml, []))]
    for name in LIGHT_TRACERS:
        _small_light(name, lit_s, device, small)
    _small_light("fog", fog_s, device, small)
    for label, h in clis:
        wall, t_build, t_render, img = _cli_wait(h)
        require(img.shape == (cw, cw, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"{label} CLI image {img.shape}, mean "
                f"{img.mean()}")
        facts[f"cli {label}"] = dict(wall=wall, build=t_build,
                                     render=t_render)
        log(f"CLI {label} ({cw}^2, hair quality "
            f"{min(quality, CLI_HAIR_QUALITY)}, 1 spp): exit 0 "
            f"in {wall:.1f}s wall beside the small renders, scene built in "
            f"{t_build}s, rendered in {t_render}s; image mean "
            f"{img.mean():.6f}")
    log(f"phase 18d and the small renders ({time.time() - t1:.1f}s): the "
        f"light tracers' CLIs ok")
    t0 = time.time()
    scene = load_scene(lit_xml, hair_quality=quality, spp_override=1,
                       device=device)
    log(f"lit: loaded in {time.time() - t0:.1f}s, "
        f"{scene.arrays.hair.p0.shape[0]} segments, "
        f"{scene.arrays.tri.p0.shape[0]} triangles, nee_probs "
        f"{scene.config.nee_probs}")
    if device == "cuda":
        t1 = time.time()
        ks = K_SURFACE
        pm = photonmap.build_photon_map(*photonmap.trace_photons(
            scene, ks["n_photons"], ks["bounces"], seed=0), ks["radius"])
        _, _, hit, _, _ = photonmap._camera_wave(scene, 0)
        r2 = torch.full_like(hit.t, ks["radius"] ** 2)
        check_kernel_k("photon_surface", pm.grid(), (hit.p, r2), report,
                       label=f"the lit cell's camera wave, "
                       f"{int(pm.valid.sum())} of {pm.pos.shape[0]} "
                       f"photon slots valid, radius {ks['radius']}")
        del pm, hit, r2
        log(f"phase 18a, surface ({time.time() - t1:.1f}s): kernel K "
            f"matches its plain version")
    # 18b: every light tracer on the lit cell
    for name in LIGHT_TRACERS:
        t1 = time.time()
        if device != "cuda":
            continue
        f = _timed_light(name, scene, reset_all)
        img = f.pop("img")
        mean = float(img.mean())
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"lit {name}: image mean {mean}")
        need = ["cull_phase_a", "phase_b", "packed_tri_closest"] + (
            ["photon_surface"] if name in ("ppm", "sppm") else [])
        require(all(f["launches"][k] > 0 for k in need),
                f"lit {name} did not launch {need}: {f['launches']}")
        f["mean"] = mean
        facts[name] = f
        log(f"phase 18b {name} ({time.time() - t1:.1f}s): {res}^2, "
            f"{f['waves']} timed wave(s) or pass(es), {f['secs']:.3f} s "
            f"each, {f['queries']:.1f} tiled queries each; image mean "
            f"{mean:.6f}; launches {f['launches']}")
        del img
    del scene
    # 18a (beam) and 18c: the fog cell
    t1 = time.time()
    scene = load_scene(fog_xml, hair_quality=quality, spp_override=1,
                       device=device)
    med = scene.medium
    log(f"fog: loaded in {time.time() - t1:.1f}s, integrator "
        f"{scene.config.integrator}, sigma_t {med.sigma_t.tolist()}, "
        f"fog depth {float(med.fog_depth)}")
    if device == "cuda":
        t1 = time.time()
        kb = K_BEAM
        vpm = photonmap.build_volume_photon_map(
            *photonmap.trace_volume_photons(scene, med, kb["n_photons"],
                                            kb["bounces"], seed=0),
            kb["radius"])
        _, ray, hit, _, _ = photonmap._camera_wave(scene, 0)
        t_end = torch.where(hit.valid, hit.t,
                            torch.clamp(med.fog_depth, max=1e6))
        n = t_end.shape[0]
        sl = slice(n // 2 - K_BEAM_LANES // 2, n // 2 + K_BEAM_LANES // 2)
        n_steps = int(min(256, math.ceil(min(float(med.fog_depth), 60.0)
                                         / kb["radius"])))
        check_kernel_k("photon_beam", vpm.grid(),
                       (ray.o[sl].contiguous(), ray.d[sl].contiguous(),
                        t_end[sl].contiguous()), report, n_steps=n_steps,
                       label=f"{K_BEAM_LANES} lanes of the fog cell's "
                       f"camera wave (lanes {sl.start}..{sl.stop - 1}), "
                       f"{n_steps} steps, {int(vpm.valid.sum())} of "
                       f"{vpm.pos.shape[0]} photon slots valid")
        del vpm, ray, hit, t_end
        log(f"phase 18a, beam ({time.time() - t1:.1f}s): kernel K matches "
            f"its plain version")
    t1 = time.time()
    if device == "cuda":
        f = _timed_light("fog", scene, reset_all)
        img = f.pop("img")
        mean = float(img.mean())
        require(np.isfinite(mean) and mean > 0
                and bool(torch.isfinite(img).all()),
                f"fog: image mean {mean}")
        need = ("cull_phase_a", "phase_b", "photon_surface", "photon_beam")
        require(all(f["launches"][k] > 0 for k in need),
                f"the fog cell did not launch {need}: {f['launches']}")
        f["mean"] = mean
        facts["fog"] = f
        log(f"phase 18c ({time.time() - t1:.1f}s): fog {res}^2, one timed "
            f"wave {f['secs']:.3f} s (both photon passes included), "
            f"{f['queries']:.1f} tiled queries; image mean {mean:.6f}; "
            f"launches {f['launches']}")
        del img
    del scene, med
    return facts, report


def k_kernel_entries(report, facts):
    """The kernels line's entries for kernel K: its time on the checked
    lanes, its launches over the main path's runs (the ppm and sppm
    passes and the fog wave for the surface mode, the fog wave for the
    beam mode)."""
    runs = {"photon_surface": ("ppm", "sppm", "fog"),
            "photon_beam": ("fog",)}
    entries = []
    for name, f in sorted(report.items()):
        launched = {r: facts[r]["launches"][name] for r in runs[name]}
        entries.append(dict(
            name=name, route="cuda", source="hairpt_torch/csrc/photons.cu",
            replaces=K_REPLACES[name], launches=sum(launched.values()),
            max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None, timed_on=f["label"],
            launched_by="the timed ppm and sppm passes (phase 18b) and the "
            "fog wave (18c)" if name == "photon_surface" else
            "the fog wave (phase 18c)", launches_by_run=launched,
            pairs=f["pairs"], lanes=f["lanes"],
            pairs_per_lane=f["pairs_per_lane"], photons=f["photons"],
            cells=f["cells"], slots=f["slots"], steps=f["steps"]))
    return entries


# ---------------------------------------------------------------------------
# phase 19: the rest of the CLI's integrators but mlt and motion (direct,
# ao, field, adaptive, multichannel, irrcache, pssmlt, erpt, spectral)
# through kernels A, B, F and kernel L (csrc/irrcache.cu, the Ward-weighted
# irradiance-cache interpolation)
# ---------------------------------------------------------------------------

L_REPLACES = "hairpt/integrators/irrcache.py:273 (XLA, no Pallas kernel)"
# L's f32 operations per (lane, record) pair, counted from irrcache.cu:
# diff 3, d2 5, ndot 5 and its clip 2, the two square roots, the division
# by k, 1 - ndot and its max, two sums (8), the ndot test, the reciprocal
# and its select, the kappa test and its select (5) = 28; the sums: w and
# w_cut (2), w e and w_cut e (12) = 14; with the gradients the cross
# product (9) and per colour 2 x (3 products, 2 sums), 2 sums and the max
# (13 x 3 = 39): 48 more
L_PAIR_FLOPS = {False: 42, True: 90}
#  kernel L against its plain version (which adds the records in L's
#  order): has_cut exactly; e bit for bit expected, held to L_RTOL relative
L_RTOL = 1e-5
# hairpt's defaults: 4,096 records, 16 rays (the cosine estimator), the
# (8, 16) grid with the gradients
IC_POINTS = 4096
IC_GRID = (8, 16)
SMALL19 = dict(res=64, quality=0.1, depth=8)
# the Markov-chain integrators at full width: hairpt's 16,384 chains or
# seeds, the mutations cut to 8 (hairpt: pssmlt 64, erpt 16)
MC_CHAINS = 1 << 14
MC_MUTATIONS = 8
# adaptive at full width: the base and extra samples cut to 2 + 2
# (hairpt: 8 + 24)
ADAPTIVE_CUT = dict(base_spp=2, extra_spp=2)
# the pool's eval_u card against CPU (19d, on the small furball): >= 99%
# of the lanes within 1e-3 relative + 1e-6
EVAL_U_SHARE = 0.99
SPECTRAL_BINS = 6
AUX_RUNS = ("direct", "ao", "field_shNormal", "field_albedo", "adaptive")


def l_bound(n_live, M, grad, N):
    """(bound ms, 'bytes' or 'operations') of one interpolation: the lanes
    (p, n, valid) and records read once, e and has_cut written once,
    against L_PAIR_FLOPS per (valid lane, record) pair."""
    n_bytes = N * (12 + 12 + 1 + 12 + 1) + M * (27 if grad else 9) * 4
    return bound_ms(n_bytes, n_live * M * L_PAIR_FLOPS[grad])


def check_kernel_l(hit, rec, report, label):
    """Kernel L against its plain version on every valid lane of a wave:
    has_cut exactly, e within L_RTOL (bit for bit expected); L timed by
    CUDA events over 5 launches, the plain version once, the bound."""
    import numpy as np
    import torch
    from hairpt_torch.ops import irrcache_interp as ic
    name = "irrcache_interp_grad" if rec.grad else "irrcache_interp"
    e_k, cut_k = ic.interp(hit.p, hit.sh_n, hit.valid, rec)
    e_p, cut_p = ic.interp_plain(hit.p, hit.sh_n, hit.valid, rec)
    torch.cuda.synchronize()
    v = hit.valid
    n_cut = int((cut_k != cut_p).sum())
    a, b = e_k[v], e_p[v]
    d = (a - b).abs()
    m = torch.maximum(a.abs(), b.abs())
    rel = torch.where(d == 0, 0.0, d / torch.where(m == 0, 1.0, m))
    max_rel = float(rel.max()) if rel.numel() else 0.0
    n_bits = int((a.view(torch.int32) != b.view(torch.int32)).any(-1).sum())
    k_ms = cuda_ms(lambda: ic.interp(hit.p, hit.sh_n, hit.valid, rec), 5)
    p_ms = cuda_ms(lambda: ic.interp_plain(hit.p, hit.sh_n, hit.valid, rec),
                   1, warm=False)
    N, M, n_live = hit.p.shape[0], rec.cpos.shape[0], int(v.sum())
    b_ms, by = l_bound(n_live, M, rec.grad, N)
    report[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                        max_abs_err=float(d.max()) if d.numel() else 0.0,
                        max_rel_err=max_rel, has_cut_differ=n_cut,
                        lanes_off_bits=n_bits, lanes=N, valid_lanes=n_live,
                        records=M, cut_share=float(cut_k[v].float().mean()),
                        label=label)
    log(f"L {name} ({label}): {n_live} valid of {N} lanes x {M} records: "
        f"has_cut differs on {n_cut}, e off the plain version's bits on "
        f"{n_bits} lanes (largest relative difference {max_rel:.3g}); "
        f"has_cut on {report[name]['cut_share']:.4f}; {k_ms:.3f} ms "
        f"(plain {p_ms:.1f} ms), bound {b_ms:.4f} ms by {by} "
        f"({k_ms / max(b_ms, 1e-12):.1f}x)")
    require(n_cut == 0 and max_rel <= L_RTOL and bool(np.isfinite(max_rel)),
            f"{name}: kernel L differs from its plain version ({n_cut} "
            f"has_cut, largest relative e difference {max_rel})")


def _timed_run(fn, reset_all):
    """Run fn(progress) once after resetting the counters: (wall s, the
    progress calls' seconds, the launches of A, B, F and L, tiled queries,
    the result). No plain version may run on the card."""
    import torch
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import irrcache_interp as ic
    from hairpt_torch.ops import tiled_kernels as tk
    times = []

    def progress(done, total, secs, n):
        times.append(secs)
    reset_all()
    itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(progress)
    torch.cuda.synchronize()
    wall = time.time() - t0
    plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA, **ic.PLAIN_ON_CUDA)
    require(all(v == 0 for v in plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return dict(wall=wall, steps=times, queries=itiled.STATS["queries"],
                launches=dict(tk.LAUNCHES, **ipk.LAUNCHES, **ic.LAUNCHES),
                out=out)


def _check_image(img, label, positive=True):
    import numpy as np
    import torch
    mean = float(img.mean())
    require(bool(torch.isfinite(img).all()) and np.isfinite(mean)
            and (mean > 0 if positive else float(img.abs().mean()) > 0),
            f"{label}: image mean {mean}")
    return mean


def _card_cpu_images(label, make, render, metric=None):
    """render(make(dev)) on the card and on the CPU: the image means (of
    |image| for a field) within MEAN_RTOL."""
    means = {}
    for dev in ("cuda", "cpu"):
        img = render(make(dev))
        _check_image(img, f"small {label} on {dev}", metric is None)
        means[dev] = float((img.abs() if metric == "abs" else img).mean())
    rel = abs(means["cuda"] - means["cpu"]) / means["cpu"]
    log(f"small {label}: image mean card {means['cuda']:.6f}, CPU "
        f"{means['cpu']:.6f}, rel diff {rel:.3g}")
    require(rel <= MEAN_RTOL, f"small {label}: card and CPU differ by {rel}")
    return rel


def integrator_cells(reset_all, device="cuda", res=1024,
                     quality=HAIR_QUALITY, small=SMALL19):
    """Phase 19: the rest of the CLI's integrators. 19a kernel L against
    its plain version on every valid lane of the floor cell's camera
    wave, with and without the records' gradients; 19b the floor cell
    through irrcache (the cache pass timed, one timed wave after a
    warm-up, with the gradient grid and with the cosine estimator); 19c
    direct, ao, field, adaptive (cut) on the XML furball; 19d pssmlt and
    erpt on it (cut mutations); 19e spectral on the Marschner furball;
    each one's small render card against CPU; 19f the CLI with
    multichannel on the furball XML and irrcache on the teapot XML.
    Returns (facts, L's report). device "cpu" rehearses the small
    renders and the CLIs only (no card)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hairpt_integ_") as tmp:
        return _integrator_cells(reset_all, device, res, quality, small, tmp)


def _integrator_cells(reset_all, device, res, quality, small, tmp):
    import numpy as np
    import torch
    from hairpt_torch.integrators import aux_integrators as aux
    from hairpt_torch.core import spectral as spec_basis
    from hairpt_torch.integrators import erpt, irrcache, pssmlt, spectral
    from hairpt_torch.ops import irrcache_interp as ic
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.furball import furball_floor_scene
    from hairpt_torch.scene.xml_loader import load_scene

    cuda = device == "cuda"
    facts = {}
    report = {} if cuda else None

    def small_floor(dev):
        return furball_floor_scene(quality=small["quality"],
                                   res=small["res"], depth=small["depth"],
                                   device=dev)

    # ---- 19a / 19b: the floor cell through irrcache ----
    t0 = time.time()
    if cuda:
        _card_cpu_images("irrcache (floor; 256 records, grid (4, 8))",
                         small_floor, lambda s: irrcache.render_irrcache(
                             s, n_points=256, grid=(4, 8), spp=1))
        scene = furball_floor_scene(quality=quality, res=res, depth=65,
                                    device=device, q=2048)
        arr = scene.arrays
        log(f"floor cell: {arr.hair.p0.shape[0]} segments, "
            f"{arr.tri.p0.shape[0]} triangles, built in "
            f"{time.time() - t0:.1f}s")
        for grad in (True, False):
            t1 = time.time()
            torch.cuda.synchronize()
            if grad:
                cache = irrcache.build_irradiance_cache(
                    scene, IC_POINTS, 16, 0, grid=IC_GRID, gradients=True)
            else:
                cache = irrcache.build_irradiance_cache(scene, IC_POINTS, 16,
                                                        0)
            torch.cuda.synchronize()
            cache_s = time.time() - t1
            rec = ic.Records(*cache)
            # 19a: L against its plain version on the camera wave
            _, _, _, _, hit = aux.camera_wave(scene, arr, 0)
            check_kernel_l(hit, rec, report,
                           f"every valid lane of the floor cell's {res}^2 "
                           f"camera wave, {IC_POINTS} records"
                           + (f", grid {IC_GRID}" if grad else
                              ", 16 cosine rays"))
            del hit
            # 19b: a warm-up wave, then one timed wave
            irrcache.render_irrcache(scene, spp=1, cache=cache)
            f = _timed_run(lambda pr: irrcache.render_irrcache(
                scene, spp=1, cache=cache, progress=pr), reset_all)
            img = f.pop("out")
            f["mean"] = _check_image(img, "floor irrcache")
            f["cache_s"] = cache_s
            f["secs"] = f["steps"][0]
            lname = "irrcache_interp_grad" if grad else "irrcache_interp"
            need = ["cull_phase_a", "phase_b", "packed_tri_closest",
                    "packed_tri_any", lname]
            require(all(f["launches"][k] > 0 for k in need),
                    f"floor irrcache did not launch {need}: {f['launches']}")
            key = "irrcache" if grad else "irrcache_nograd"
            facts[key] = f
            est = "gradients (8, 16)" if grad \
                else "cosine rays, no gradients"
            log(f"phase 19a/b, irrcache {est} "
                f"({time.time() - t1:.1f}s): cache pass {cache_s:.3f} s "
                f"({IC_POINTS} points), one timed {res}^2 wave "
                f"{f['secs']:.3f} s, {f['queries']} tiled queries; image "
                f"mean {f['mean']:.6f}; launches {f['launches']}")
            del img, cache, rec
        del scene, arr

    # ---- 19c / 19d: the XML furball ----
    fur_xml = scene_xmls.write_scene(tmp, "furball", res=res)
    fur_s = scene_xmls.write_scene(os.path.join(tmp, "small"), "furball",
                                   res=small["res"])

    def small_fur(dev):
        return load_scene(fur_s, hair_quality=small["quality"],
                          spp_override=1, max_depth_override=small["depth"],
                          device=dev)
    # 19f: the CLIs run beside the small renders (card against CPU)
    t_cli = time.time()
    cw = min(res, CLI_WIDTH)
    tea = scene_xmls.write_scene(tmp, "teapot")
    multi = os.path.join(tmp, "out", "multi.png")
    clis = [("multichannel", _cli_start(
        fur_xml, multi, quality, device, spp=1, res_scale=cw / res,
        extra=["--integrator", "multichannel"])),
        ("irrcache", _cli_start(
            tea, os.path.join(tmp, "out", "tea_ic.png"), quality, device,
            spp=1, res_scale=CLI_WIDTH / TEAPOT_RES[0],
            extra=["--integrator", "irrcache"]))]
    runs = {
        "direct": (lambda s, pr: aux.render_direct(s, spp=1, progress=pr),
                   None),
        "ao": (lambda s, pr: aux.render_ao(s, spp=1, progress=pr), None),
        "field_shNormal": (lambda s, pr: aux.render_field(
            s, "shNormal", progress=pr), "abs"),
        "field_albedo": (lambda s, pr: aux.render_field(
            s, "albedo", progress=pr), None),
        "adaptive": (lambda s, pr: aux.render_adaptive(
            s, seed=0, progress=pr, **ADAPTIVE_CUT), None),
    }
    for name, (run, metric) in runs.items():
        if cuda:
            _card_cpu_images(name, small_fur, lambda s: run(s, None), metric)
    if cuda:
        chans = {d: aux.render_multichannel(small_fur(d), spp=1)
                 for d in ("cuda", "cpu")}
        for ch in chans["cpu"]:
            _card_cpu_images(f"multichannel {ch}", lambda d: chans[d][ch],
                             lambda img: img,
                             "abs" if ch == "shNormal" else None)
        del chans
    for name, h in clis:
        wall, t_build, t_render, img = _cli_wait(h)
        require(np.isfinite(img).all() and img.mean() > 0,
                f"{name} CLI image mean {img.mean()}")
        if name == "multichannel":
            require(img.shape == (cw, cw, 3), f"multichannel CLI image "
                    f"{img.shape}")
            for ch in ("shNormal", "distance", "albedo"):
                c = np.load(multi[:-4] + f".{ch}.npy")
                require(c.shape == (cw, cw, 3) and np.isfinite(c).all()
                        and np.abs(c).mean() > 0, f"multichannel CLI "
                        f"channel {ch}: {c.shape}")
        facts[f"cli {name}"] = dict(wall=wall, build=t_build,
                                    render=t_render)
        on = "the furball" if name == "multichannel" else "the teapot"
        log(f"CLI {name} on {on} ({img.shape[1]} x {img.shape[0]}, hair "
            f"quality "
            f"{min(quality, CLI_HAIR_QUALITY)}, 1 spp): exit 0 in "
            f"{wall:.1f}s wall beside the small renders, built in "
            f"{t_build}s, rendered in {t_render}s"
            + ("; the radiance and the shNormal, distance and albedo .npy "
               "channels finite" if name == "multichannel" else
               f" ({IC_POINTS} records, the cache pass included)")
            + f"; image mean {img.mean():.6f}")
    log(f"phase 19f and the small renders of 19c "
        f"({time.time() - t_cli:.1f}s): the CLIs ok")
    if cuda:
        t0 = time.time()
        scene = load_scene(fur_xml, hair_quality=quality, spp_override=1,
                           device=device)
        log(f"XML furball loaded in {time.time() - t0:.1f}s, "
            f"{scene.arrays.hair.p0.shape[0]} segments")
        for name, (run, metric) in runs.items():
            t1 = time.time()
            f = _timed_run(lambda pr: run(scene, pr), reset_all)
            img = f.pop("out")
            f["mean"] = _check_image(img, name, metric is None)
            f["secs"] = sum(f["steps"]) / max(len(f["steps"]), 1)
            require(all(f["launches"][k] > 0
                        for k in ("cull_phase_a", "phase_b")),
                    f"{name} did not launch A and B: {f['launches']}")
            facts[name] = f
            log(f"phase 19c {name} ({time.time() - t1:.1f}s): {res}^2, "
                f"{len(f['steps'])} timed wave(s), {f['secs']:.3f} s each, "
                f"{f['queries'] / max(len(f['steps']), 1):.1f} tiled "
                f"queries each; image mean {f['mean']:.6f}; launches "
                f"{f['launches']}" + (f" (base and extra samples cut to "
                                      f"{ADAPTIVE_CUT})"
                                      if name == "adaptive" else ""))
            del img
    # 19d: the Markov chains
    t0 = time.time()
    if cuda:
        sf = {d: small_fur(d) for d in ("cuda", "cpu")}
        got = {}
        for d, s in sf.items():
            ev, n_dims = pssmlt.make_eval_u(s)
            idx = torch.arange(4096, device=s.arrays.device)
            u = pssmlt.fresh_uniforms(idx, 7919 + 1, 0, n_dims)
            got[d] = [x.cpu() for x in ev(s.arrays, u)]
        ok = torch.isclose(got["cuda"][1], got["cpu"][1], rtol=1e-3,
                           atol=1e-6).all(-1)
        share = float(ok.float().mean())
        pos_eq = bool(torch.equal(got["cuda"][0], got["cpu"][0]))
        log(f"small pool eval_u (4096 lanes, {n_dims} dims): positions "
            f"equal {pos_eq}, radiance within 1e-3 on {share:.4f} of the "
            f"lanes")
        require(pos_eq and share >= EVAL_U_SHARE,
                f"eval_u card against CPU: positions equal {pos_eq}, "
                f"{share} of the lanes agree")
        facts["eval_u_share"] = share
        del sf
        _card_cpu_images("pssmlt", small_fur, lambda s: pssmlt.render_pssmlt(
            s, n_chains=1024, n_mutations=4))
        _card_cpu_images("erpt", small_fur, lambda s: erpt.render_erpt(
            s, n_seeds=1024, n_mutations=4))
        for name, fn, chains in (
                ("pssmlt", pssmlt.render_pssmlt, pssmlt.pssmlt_chains),
                ("erpt", erpt.render_erpt, erpt.erpt_chains)):
            t1 = time.time()
            kw = {"n_chains" if name == "pssmlt" else "n_seeds": MC_CHAINS}
            f = _timed_run(lambda pr: fn(scene, n_mutations=MC_MUTATIONS,
                                         progress=pr, **kw), reset_all)
            img = f.pop("out")
            f["mean"] = _check_image(img, name)
            f["secs"] = sum(f["steps"]) / len(f["steps"])
            # the same chains again, for their pool's b and accept flags
            ch = chains(scene, n_mutations=MC_MUTATIONS, **kw)
            f["accept_share"] = float(torch.stack(
                [acc for _, acc in ch.steps]).float().mean())
            f["b"] = float(ch.b)
            require(all(f["launches"][k] > 0
                        for k in ("cull_phase_a", "phase_b")),
                    f"{name} did not launch A and B: {f['launches']}")
            facts[name] = f
            log(f"phase 19d {name} ({time.time() - t1:.1f}s): {MC_CHAINS} "
                f"chains x {MC_MUTATIONS} mutations (cut) at {res}^2, "
                f"depth 65: {f['wall']:.2f} s in all with the pool, "
                f"{f['secs']:.3f} s per Metropolis step, "
                f"{f['queries'] / (MC_MUTATIONS + 1):.1f} tiled queries per "
                f"step, accepted {f['accept_share']:.3f}, b {f['b']:.5f}; "
                f"image mean {f['mean']:.6f}; launches {f['launches']}")
            del img
        del scene

    # ---- 19e: spectral on the Marschner furball ----
    t0 = time.time()
    if cuda:
        mat_s = scene_xmls.write_scene(os.path.join(tmp, "small"),
                                       "materials", res=32)
        _card_cpu_images(
            f"spectral ({SPECTRAL_BINS} bins, dispersion 0.0042, the "
            f"materials stand-in's dielectrics)",
            lambda d: load_scene(mat_s, hair_quality=0.1, spp_override=1,
                                 max_depth_override=4, device=d),
            lambda s: spectral.render_spectral(s, n_bins=SPECTRAL_BINS,
                                               spp=1, cauchy_b=0.0042))
        scene = bench_scene(quality=quality, res=res, depth=65, spp=1,
                            device=device, material="marschner")
        f = _timed_run(lambda pr: spectral.render_spectral(
            scene, n_bins=SPECTRAL_BINS, spp=1, progress=pr), reset_all)
        img = f.pop("out")
        f["mean"] = _check_image(img, "spectral")
        # at 1 spp a band's path render is one wave: one progress call
        bands = SPECTRAL_BINS // 3
        require(len(f["steps"]) == bands, f"spectral: {len(f['steps'])} "
                f"waves for {bands} bands")
        f["band_s"] = f["steps"]
        f["secs"] = sum(f["band_s"]) / bands
        # each band's arrays and Marschner tables, timed alone
        A, lam, _ = spec_basis.upsample_basis(SPECTRAL_BINS)
        f["tables_s"] = []
        for g in range(bands):
            torch.cuda.synchronize()
            t1 = time.time()
            spectral.respectralize_arrays(scene, A[3 * g:3 * g + 3],
                                          lam[3 * g:3 * g + 3])
            torch.cuda.synchronize()
            f["tables_s"].append(time.time() - t1)
        require(all(f["launches"][k] > 0 for k in ("cull_phase_a", "phase_b")),
                f"spectral did not launch A and B: {f['launches']}")
        facts["spectral"] = f
        log(f"phase 19e ({time.time() - t0:.1f}s): spectral, "
            f"{SPECTRAL_BINS} bins in {bands} bands at {res}^2, 1 spp, "
            f"the Marschner furball: {f['secs']:.3f} s per band, the band "
            f"arrays and tables {[round(x, 3) for x in f['tables_s']]} s; "
            f"image mean {f['mean']:.6f}; launches {f['launches']}")
        del scene, img

    return facts, report


def l_kernel_entries(report, facts):
    """The kernels line's entries for kernel L: its time on the floor
    cell's camera wave, its launches over the timed irrcache waves (the
    gradient instance in the default wave, the other in the wave on the
    cosine-ray cache)."""
    runs = {"irrcache_interp_grad": "irrcache",
            "irrcache_interp": "irrcache_nograd"}
    entries = []
    for name, f in sorted(report.items()):
        run = runs[name]
        entries.append(dict(
            name=name, route="cuda", source="hairpt_torch/csrc/irrcache.cu",
            replaces=L_REPLACES, launches=facts[run]["launches"][name],
            max_abs_err=f["max_abs_err"], max_rel_err=f["max_rel_err"],
            has_cut_differ=f["has_cut_differ"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None, timed_on=f["label"],
            launched_by=f"the timed floor-cell wave of phase 19b ({run})",
            lanes=f["lanes"], valid_lanes=f["valid_lanes"],
            records=f["records"], cut_share=f["cut_share"]))
    return entries


# ---------------------------------------------------------------------------
# phase 20: path-space MLT with the manifold walk, and the motion-vector
# integrator, through kernels A, B and F (no new kernel: queries of 16,384
# lanes and per-lane algebra)
# ---------------------------------------------------------------------------

# 20a: the mutations cut from hairpt's 64 to 10 (two rounds of the five
# phases, so both bidirectional classes run); hairpt's 16,384 chains and
# 16-fold pool
MLT_MUTATIONS = 10
MLT_PHASES = ("lens", "caustic", "manifold", "bidir", "mchain")
# 20b: the small materials cell's first round, card against CPU: the pool
# pick, each step's ok flags and its a (within 1e-3 relative + 1e-5) on
# >= MLT_LANE_SHARE of the lanes
MLT_SMALL_CHAINS = 1024
MLT_LANE_SHARE = 0.97
# 20c: the manifold walk on tests/test_manifold.py's mirror sphere (4,096
# lanes): ok equal on >= 99% of the lanes, x within 1e-4 of the chord, and
# every converged point within 0.03 of the analytic Fermat point
WALK_LANES = 4096
WALK_A = (0.0, 0.0, -3.0)
WALK_B = (2.0, 1.0, -2.5)
# 20d: the motion vectors' chain configs card against CPU: +inf pixels
# equal, finite ones within MOTION_PX_TOL
MOTION_PX_TOL = 1e-3
MOTION_W = 64


def _ab_f(launches):
    """The launches of A, B and F in a counter dict."""
    return {k: launches.get(k, 0) for k in ("cull_phase_a", "phase_b",
                                            "packed_tri_closest",
                                            "packed_tri_any")}


def mlt_full(scene, reset_all, n_mutations=MLT_MUTATIONS, n_chains=None):
    """20a (on the materials cell, inside phase 16c): render_mlt's chains
    at hairpt's 16,384 chains and 16-fold pool with n_mutations steps:
    the pool's s, each step's s (after a sync) and its phase's share of
    matching chains and mean a, tiled queries and A, B, F launches per
    round; the image (render_mlt's scale) finite with a positive mean."""
    import numpy as np
    import torch
    from hairpt_torch.film import film as film_mod
    from hairpt_torch.integrators import mlt
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    n = n_chains or MC_CHAINS
    cfg = scene.config
    dev = scene.arrays.device
    cuda = dev.type == "cuda"

    def counts():
        return dict(_ab_f(dict(tk.LAUNCHES, **ipk.LAUNCHES)),
                    queries=itiled.STATS["queries"])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    reset_all()
    itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
    sync()
    t0 = time.time()
    ch = mlt.mlt_chains(scene, n_chains=n, n_mutations=n_mutations, seed=0)
    pool = counts()
    splat = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    steps, rounds = [], []
    last = counts()
    t1 = time.time()
    for s in ch.steps:
        for pos, rgb in s.splats:
            splat = film_mod.splat_add_only(scene.film, pos, rgb, splat)
        sync()
        secs = time.time() - t1
        steps.append(dict(phase=s.phase, r=s.r, secs=secs,
                          match=mlt.match_share(s.phase, s.st,
                                                scene.arrays),
                          ok=float((s.a > 0).float().mean()),
                          mean_a=float(s.a.mean()),
                          accepted=float(s.acc.float().mean())))
        if s.phase == MLT_PHASES[-1]:
            now = counts()
            rounds.append({k: now[k] - last[k] for k in now})
            last = now
        t1 = time.time()
    img = splat * (ch.b * (cfg.width * cfg.height) / (n * ch.total_steps))
    sync()
    wall = time.time() - t0
    mean = float(img.mean())
    plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
    require(bool(torch.isfinite(img).all()) and np.isfinite(mean)
            and mean > 0, f"mlt image mean {mean}")
    per_round = [sum(x["secs"] for x in steps if x["r"] == r)
                 for r in range(len(rounds))]
    kinds = {}
    for ph in MLT_PHASES:
        xs = [x for x in steps if x["phase"] == ph]
        kinds[ph] = dict(secs=sum(x["secs"] for x in xs) / len(xs),
                         match=sum(x["match"] for x in xs) / len(xs),
                         ok=sum(x["ok"] for x in xs) / len(xs),
                         mean_a=sum(x["mean_a"] for x in xs) / len(xs),
                         accepted=sum(x["accepted"] for x in xs) / len(xs))
    facts = dict(pool_s=ch.pool_s, wall=wall, round_s=per_round,
                 kinds=kinds, rounds=rounds, pool=pool, mean=mean,
                 b=float(ch.b), n=n, steps=ch.total_steps)
    log(f"20a mlt: {n} chains, a pool of {n * 16} lanes in "
        f"{ch.pool_s:.3f} s ({pool['queries']} tiled queries, A/B/F "
        f"{_ab_f(pool)}), {ch.total_steps} steps ({n_mutations} of hairpt's "
        f"64) in {len(rounds)} rounds: {[round(x, 3) for x in per_round]} "
        f"s per round; per kind s, matching share, ok share, mean a, "
        + "; ".join(f"{k} {v['secs']:.3f} s {v['match']:.4f} {v['ok']:.4f} "
                    f"{v['mean_a']:.4f}" for k, v in kinds.items())
        + f"; per round {rounds}; image mean {mean:.6f}, b {facts['b']:.6f},"
          f" {wall:.2f} s in all")
    if cuda:
        require(all(all(r[k] > 0 for k in ("cull_phase_a", "phase_b",
                                            "packed_tri_closest",
                                            "packed_tri_any"))
                    for r in rounds),
                f"an mlt round did not launch A, B and F: {rounds}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
    return facts


def motion_full(scene, reset_all):
    """20d's full-width part (on the motion cell, inside phase 14b): one
    wave of render_motion with the 'd' configuration: s per wave, tiled
    queries, A, B, F and G launches; finite vectors on the hit pixels."""
    import torch
    from hairpt_torch.integrators import motion
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    motion.render_motion(scene)            # warm-up
    reset_all()
    itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
    torch.cuda.synchronize()
    t0 = time.time()
    img = motion.render_motion(scene)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(_ab_f(dict(tk.LAUNCHES, **ipk.LAUNCHES)),
                    **gi.LAUNCHES)
    fin = torch.isfinite(img).all(-1)
    share = float(fin.float().mean())
    moving = float((img[fin].abs().amax(-1) > 1e-3).float().mean())
    log(f"20d motion vectors ('d') on the motion cell "
        f"({scene.config.width}^2): {secs:.3f} s per wave, "
        f"{itiled.STATS['queries']} tiled queries, launches {launches}; "
        f"{share:.4f} of the pixels tracked, {moving:.4f} of them moving; "
        f"+inf elsewhere")
    require(share > 0.1 and moving > 0.1 and bool(
        (img[~fin] == float("inf")).all()), f"motion vectors: {share} "
        f"tracked, {moving} moving")
    require(launches["cull_phase_a"] > 0 and launches["phase_b"] > 0
            and launches["packed_tri_closest"] > 0,
            f"the motion-vector wave did not launch A, B and F: {launches}")
    return dict(secs=secs, launches=launches, tracked=share,
                queries=itiled.STATS["queries"])


def _translate(v):
    import numpy as np
    m = np.eye(4)
    m[:3, 3] = v
    return m


def motion_chain_scene(kind, device):
    """tests/test_motion.py's 'rd' mirror (a mirror at z = 3, a quad
    behind the camera moving +0.4 in x) or 'ttd' thin glass (a slab of
    IOR 1.5 at z = 1.4 / 1.6, a quad at z = 3 moving +0.3), at
    MOTION_W^2."""
    import numpy as np
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene.scene import SceneBuilder

    def scaled(z, s):
        m = _translate([0, 0, z])
        m[0, 0] = m[1, 1] = s
        return m
    b = SceneBuilder(device=device)
    d = b.add_material(kind=mat.DIFFUSE, diffuse=(0.5, 0.5, 0.5))
    if kind == "rd":
        m = b.add_material(kind=mat.CONDUCTOR, diffuse=(1.0, 1.0, 1.0))
        b.add_mesh(shp.rectangle(), m, to_world=scaled(3.0, 3.0))
        b.add_mesh(shp.rectangle(), d, to_world=_translate([0, 0, -2.0]),
                   motion=_translate([0.4, 0, 0]))
    else:
        g = b.add_material(kind=mat.DIELECTRIC, eta=1.5)
        for z in (1.4, 1.6):
            b.add_mesh(shp.rectangle(), g, to_world=scaled(z, 3.0))
        b.add_mesh(shp.rectangle(), d, to_world=scaled(3.0, 2.0),
                   motion=_translate([0.3, 0, 0]))
    W = MOTION_W
    return b.build(Camera.perspective(np.eye(4), 90.0, W, W),
                   Film.make(W, W, "box"), spp=1, max_depth=4,
                   traversal="packed")


def _fermat_sphere(a, b):
    """The reflection point on the unit sphere seen from a and b
    (tests/test_manifold.py's oracle: a grid, then local refinement)."""
    import numpy as np
    th = np.linspace(0, np.pi, 400)
    ph = np.linspace(-np.pi, np.pi, 800)
    T, P = np.meshgrid(th, ph, indexing="ij")
    x = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                  np.cos(T)], -1)
    cost = np.linalg.norm(x - a, axis=-1) + np.linalg.norm(x - b, axis=-1)
    cost[~((x @ a > 0) & (x @ b > 0))] = np.inf
    i, j = np.unravel_index(np.argmin(cost), cost.shape)
    for _ in range(40):
        dth = th[1] - th[0]
        th2 = np.linspace(T[i, j] - dth, T[i, j] + dth, 21)
        ph2 = np.linspace(P[i, j] - dth, P[i, j] + dth, 21)
        T, P = np.meshgrid(th2, ph2, indexing="ij")
        x = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                      np.cos(T)], -1)
        cost = np.linalg.norm(x - a, axis=-1) \
            + np.linalg.norm(x - b, axis=-1)
        i, j = np.unravel_index(np.argmin(cost), cost.shape)
        th = th2
    return x[i, j]


def walk_run(dev):
    """20c on one device: the manifold walk (16 iterations, 80 queries) on
    the unit mirror sphere (96 x 192 triangles) from WALK_A to WALK_B,
    WALK_LANES lanes started from jittered rays: x, ok, the seconds, the
    converged share and the converged points' largest distance to the
    analytic reflection point."""
    import numpy as np
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.film.film import Film
    from hairpt_torch.integrators import manifold
    from hairpt_torch.integrators.common import scene_intersect
    from hairpt_torch.integrators.path import _swept_params
    from hairpt_torch.models import shapes as shp
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene.scene import SceneBuilder

    a = np.asarray(WALK_A, np.float32)
    bp = np.asarray(WALK_B, np.float32)
    rs = np.random.RandomState(0)
    tgt = np.array([0.15, 0.1, 1.0]) + rs.randn(WALK_LANES, 3) * 0.05
    d0 = (tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)).astype(
        np.float32)
    b = SceneBuilder(device=dev)
    b.add_mesh(shp.sphere(1.0, 96, 192), b.add_material(kind=mat.DIFFUSE))
    s = b.build(Camera.perspective(np.eye(4), 60.0, 8, 8),
                Film.make(8, 8, "box"), spp=1, max_depth=2)
    n = WALK_LANES
    at = torch.as_tensor(np.tile(a, (n, 1)), device=dev)
    bt = torch.as_tensor(np.tile(bp, (n, 1)), device=dev)
    h = scene_intersect(s.arrays, Ray(
        o=at, d=torch.as_tensor(d0, device=dev),
        mint=torch.zeros(n, device=dev),
        maxt=torch.full((n,), float("inf"), device=dev)),
        **_swept_params(s.config))
    t0 = time.time()
    x, _, ok = manifold.walk(s.arrays, s.config, at, bt, h)
    x, ok = x.cpu().numpy(), ok.cpu().numpy()
    secs = time.time() - t0
    dist = np.linalg.norm(x[ok] - _fermat_sphere(a, bp), axis=-1)
    out = dict(x=x, ok=ok, secs=secs, conv=float(ok.mean()),
               dist=float(dist.max()) if ok.any() else float("inf"))
    log(f"20c manifold walk on {dev}: {n} lanes, {out['conv']:.4f} "
        f"converged in {secs:.3f} s (80 queries), largest distance to the "
        f"Fermat point {out['dist']:.4g}")
    require(out["conv"] > 0.5 and out["dist"] < 0.03,
            f"the manifold walk on {dev}: {out['conv']} converged, "
            f"{out['dist']} from the Fermat point")
    return out


def walk_compare(c, p):
    """20c card against CPU: ok equal on >= 99% of the lanes, x within
    1e-4 of the chord on the lanes both call ok."""
    import numpy as np
    ok_eq = float((c["ok"] == p["ok"]).mean())
    both = c["ok"] & p["ok"]
    chord = np.linalg.norm(np.asarray(WALK_A) - p["x"][both], axis=-1)
    err = float((np.linalg.norm(c["x"][both] - p["x"][both], axis=-1)
                 / chord).max())
    log(f"20c card against CPU: ok equal on {ok_eq:.4f} of the lanes, x "
        f"within {err:.3g} of the chord")
    require(ok_eq >= 0.99 and err <= 1e-4, f"the manifold walk card against "
            f"CPU: ok equal on {ok_eq}, x within {err}")
    return dict(ok_eq=ok_eq, err=err)


def mlt_small_run(dev, small=SMALL19):
    """20b on one device: the small materials cell (materials_builder at
    small's res and quality, depth 8) through MLT_SMALL_CHAINS chains,
    one round: the pool's luminances, the pick, each step's ok flags and
    a, the image mean."""
    import torch
    from hairpt_torch.film import film as film_mod
    from hairpt_torch.integrators import mlt

    s = with_config(materials_builder(small["res"], dev, small["quality"]),
                    max_depth=small["depth"])
    t0 = time.time()
    ch = mlt.mlt_chains(s, n_chains=MLT_SMALL_CHAINS,
                        n_mutations=len(MLT_PHASES), seed=0)
    splat = torch.zeros((s.config.height, s.config.width, 3),
                        device=s.arrays.device)
    ok, a = [], []
    for st in ch.steps:
        for pos, rgb in st.splats:
            splat = film_mod.splat_add_only(s.film, pos, rgb, splat)
        ok.append((st.a > 0).cpu())
        a.append(st.a.cpu())
    img = splat * (ch.b * (s.config.width * s.config.height)
                   / (MLT_SMALL_CHAINS * ch.total_steps))
    out = dict(pick=ch.pick.cpu(), l_pool=ch.l_pool.cpu(), ok=ok, a=a,
               mean=_check_image(img, f"small mlt on {dev}"),
               secs=time.time() - t0)
    log(f"20b small mlt on {dev}: {out['secs']:.1f} s, image mean "
        f"{out['mean']:.6f}")
    return out


def mlt_small_compare(c, p):
    """20b card against CPU: the pool's luminances lane by lane (>=
    MLT_LANE_SHARE within 1e-3 relative + 1e-6); the pick from the CPU's
    luminances on the card equal to the CPU's on >= 99.9% of the chains;
    on the chains whose own picks agree, each step's ok flags and a
    (1e-3 relative + 1e-5) on >= MLT_LANE_SHARE; the image means within
    MEAN_RTOL. The share of chains whose picks agree is reported: a pool
    path that diverges between the devices (float32 rounding of a
    sampling decision) moves the cumulative sum behind it."""
    import torch
    from hairpt_torch.core import rng
    from hairpt_torch.integrators.pssmlt import pick_from_pool

    lp = torch.isclose(c["l_pool"], p["l_pool"], rtol=1e-3, atol=1e-6)
    l_share = float(lp.float().mean())
    n = c["pick"].shape[0]
    idx = torch.arange(n, device="cuda")
    pick_k = pick_from_pool(p["l_pool"].cuda(),
                            rng.uniform_1d(idx, 9, 0)).cpu()
    machine = float((pick_k == p["pick"]).float().mean())
    same = c["pick"] == p["pick"]
    pick = float(same.float().mean())
    shares = []
    for oc, op, ac, ap in zip(c["ok"], p["ok"], c["a"], p["a"]):
        agree = (oc == op) & torch.isclose(ac, ap, rtol=1e-3, atol=1e-5)
        shares.append(float(agree[same].float().mean()))
    rel = abs(c["mean"] - p["mean"]) / p["mean"]
    log(f"20b card against CPU: pool luminances within 1e-3 on {l_share:.4f}"
        f" of the {c['l_pool'].shape[0]} lanes; the card's pick from the "
        f"CPU's pool equal on {machine:.4f}; the chains' own picks equal on "
        f"{pick:.4f}; on those, ok and a agree per step on "
        f"{dict(zip(MLT_PHASES, [round(x, 4) for x in shares]))}; image "
        f"means rel diff {rel:.3g}")
    require(l_share >= MLT_LANE_SHARE and machine >= 0.999
            and min(shares) >= MLT_LANE_SHARE and rel <= MEAN_RTOL,
            f"small mlt card against CPU: pool {l_share}, pick {machine}, "
            f"steps {shares}, means {rel}")
    return dict(pool=l_share, pick_machine=machine, pick=pick,
                shares=shares, rel=rel)


def motion_chains_run(dev):
    """20d's small part on one device: 'rd' and 'ttd' on
    tests/test_motion.py's scenes at MOTION_W^2."""
    import numpy as np
    from hairpt_torch.integrators import motion

    imgs = {}
    for kind in ("rd", "ttd"):
        t0 = time.time()
        imgs[kind] = motion.render_motion(motion_chain_scene(kind, dev),
                                          config=kind).cpu().numpy()
        log(f"20d '{kind}' on {dev}: {time.time() - t0:.2f} s, "
            f"{np.isfinite(imgs[kind]).all(-1).mean():.4f} of the pixels "
            f"tracked")
    return imgs


def motion_chains_compare(c, p):
    """20d card against CPU: the +inf pixels equal, the finite ones
    within MOTION_PX_TOL."""
    import numpy as np
    out = {}
    for kind in ("rd", "ttd"):
        a, b = c[kind], p[kind]
        fa, fb = np.isfinite(a), np.isfinite(b)
        same = bool((fa == fb).all()) and bool((a[~fa] == np.inf).all())
        err = float(np.abs(a[fa & fb] - b[fa & fb]).max()) \
            if (fa & fb).any() else 0.0
        out[kind] = dict(same_inf=same, err=err,
                         tracked=float(fb.all(-1).mean()))
        log(f"20d '{kind}' card against CPU: +inf pixels equal {same}, "
            f"finite ones within {err:.3g}")
        require(same and err <= MOTION_PX_TOL and fb.any(),
                f"motion '{kind}' card against CPU: +inf equal {same}, "
                f"largest difference {err}")
    return out


def cpu_refs(path, which="mlt", xml=None):
    """The CPU sides of 20b, 20c and 20d (chip_smoke.py --cpu-refs PATH,
    a subprocess of phase 20 beside its card work), or with which
    "cloth" those of 21b (chip_smoke.py --cpu-refs PATH cloth XML, the
    small cloth render of XML; a subprocess of phase 21), saved to PATH
    with torch.save. Four intra-op threads, so the card's process keeps
    its cores."""
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        if which == "cloth":
            refs = dict(lanes=cloth_lanes_run("cpu"),
                        small=cloth_small_run("cpu", xml))
        else:
            refs = dict(mlt=mlt_small_run("cpu"), walk=walk_run("cpu"),
                        motion=motion_chains_run("cpu"))
    except SmokeFailure as e:
        print(f"chip_smoke --cpu-refs: FAILED: {e}", file=sys.stderr)
        return 1
    torch.save(refs, path)
    return 0


def mlt_motion_cells(device="cuda", quality=HAIR_QUALITY):
    """Phase 20's parts after phase 19: the CPU sides of 20b-20d in a
    subprocess (cpu_refs) and the CLIs (20e: --integrator mlt on the
    teapot XML at CLI_WIDTH across with hairpt's defaults, --integrator
    motion on the motion XML) started first; the card sides of 20b, 20c
    and 20d's chain configs beside them, then each held against its CPU
    side. device "cpu" rehearses the CLIs and the CPU sides only."""
    import tempfile
    import numpy as np
    import torch
    from hairpt_torch.scene import scene_xmls

    here = os.path.dirname(os.path.abspath(__file__))
    facts = {}
    with tempfile.TemporaryDirectory(prefix="hairpt_mlt_") as tmp:
        t_all = time.time()
        refs = os.path.join(tmp, "cpu_refs.pt")
        err = open(os.path.join(tmp, "cpu_refs.stderr"), "w+")
        ref_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-refs", refs],
            cwd=here, stdout=subprocess.DEVNULL, stderr=err)
        tea = scene_xmls.write_scene(tmp, "teapot")
        mot = scene_xmls.write_scene(tmp, "motion")
        clis = [("mlt", _cli_start(
            tea, os.path.join(tmp, "out", "tea_mlt.png"), quality, device,
            spp=1, res_scale=CLI_WIDTH / TEAPOT_RES[0],
            extra=["--integrator", "mlt"])),
            ("motion", _cli_start(
                mot, os.path.join(tmp, "out", "motion_vec.exr"), quality,
                device, spp=1, res_scale=CLI_WIDTH / 1024,
                extra=["--integrator", "motion"]))]
        card = None
        if device == "cuda":
            t0 = time.time()
            card = dict(mlt=mlt_small_run("cuda"), walk=walk_run("cuda"),
                        motion=motion_chains_run("cuda"))
            log(f"phase 20b-20d on the card ({time.time() - t0:.1f}s)")
        try:
            rc = ref_proc.wait(timeout=600)
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
                ref_proc.wait()
        err.seek(0)
        msg = err.read()
        err.close()
        require(rc == 0, f"the CPU references exited {rc}:\n{msg[-3000:]}")
        log(f"20b-20d CPU references in a subprocess: "
            f"{time.time() - t_all:.1f}s wall")
        if card is not None:
            ref = torch.load(refs, weights_only=False)
            facts["small"] = mlt_small_compare(card["mlt"], ref["mlt"])
            facts["walk"] = walk_compare(card["walk"], ref["walk"])
            facts["chains"] = motion_chains_compare(card["motion"],
                                                    ref["motion"])
        for name, h in clis:
            wall, t_build, t_render, img = _cli_wait(h)
            fin = np.isfinite(img)
            if name == "mlt":
                require(fin.all() and img.mean() > 0,
                        f"mlt CLI image mean {img.mean()}")
            else:
                require(fin.any() and (img[~fin] == np.inf).all(),
                        "motion CLI image has no tracked pixel")
            facts[f"cli {name}"] = dict(wall=wall, build=t_build,
                                        render=t_render)
            log(f"20e CLI {name} ({img.shape[1]} x {img.shape[0]}): exit 0 "
                f"in {wall:.1f}s wall beside 20b-20d, built in {t_build}s, "
                f"rendered in {t_render}s"
                + (f"; image mean {img.mean():.6f}" if name == "mlt" else
                   f"; {fin.all(-1).mean():.4f} of the pixels tracked"))
        log(f"phase 20b-20e ({time.time() - t_all:.1f}s): ok")
    return facts

# ---------------------------------------------------------------------------
# phase 21: the irawan woven cloth under the furball, and the CLI's banded
# render, --stats, --profile, util and import, through kernels A, B and F
# (no new kernel: the cloth's yarn resolution and integrand are per-lane
# algebra at the gather and at shading)
# ---------------------------------------------------------------------------

# 21a: at least this share of the camera wave's lanes hit cloth
CLOTH_SHARE_MIN = 0.2
# 21b: lanes of the resolve, eval and sample checks; cloth_resolve's floats
# and pack_cloth's spec_norm within 1e-5 relative (the same IEEE + - * /
# on both, the card's log, tan and atan a few ulps apart), the yarn ids
# and flags equal; f within 1e-4 relative on >= 99.9% of the lanes (the
# integrand's selections may flip where a transcendental rounds across an
# edge); pdf within 1e-6
CLOTH_LANES = 1 << 20
CLOTH_RESOLVE_RTOL = 1e-5
CLOTH_F_RTOL = 1e-4
CLOTH_F_SHARE = 0.999
CLOTH_PDF_ATOL = 1e-6
# the small render: the cloth stand-in without its hair (the plain tiled
# traversal dominates the CPU side's time) at 32 spp. The cloth's
# highlights (spec_norm about 60) give single pixels hundreds of times
# the mean, and its weave (512 tiles of 4 yarns across the floor's uv)
# magnifies a hit's uv rounding 2,048-fold, so a path that rounds across
# a highlight's edge on one side only turns into a firefly there: card
# and CPU means were 5.2% apart at 1 spp and 2.2% at 4 spp with the hair
# (NVIDIA H100, 700 W), one firefly each time
SMALL21 = dict(res=64, depth=8, spp=32)
# 21c: the banded CLI's rows per band; util resample's size and its card
# against CPU tolerance (relative, plus 1e-6 of the largest value: the
# products' summation orders differ); the EXR against the in-process
# image: half precision's rounding (2^-11 relative, subnormals below
# 2^-14 to 2^-24 absolute) plus the film's atomics order (1e-5 relative)
CLOTH_BANDS = 64
# appends a constant emitter to the scene XML named by argv[1]
GRAFT_EMITTER = ("import sys; p = sys.argv[1]; t = open(p).read(); "
                 "open(p, 'w').write(t.replace('</scene>', "
                 "'<emitter type=\"constant\"/></scene>'))")
RESAMPLE_SIZE = 512
RESAMPLE_RTOL = 1e-5
EXR_RTOL = 2.0 ** -11 + 1e-5
EXR_ATOL = 2.0 ** -24


def cloth_material_table(dev):
    """The cloth cell's two weaves (the built-in plain one of the backdrop
    and the floor's twill.wv with its $vars) as material rows through the
    SceneBuilder, packed with their ClothTable on `dev`."""
    from hairpt_torch.models.bsdf import cloth
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.scene import SceneBuilder
    b = SceneBuilder(device=dev)
    for text, props, part in (
            (cloth.BUILTIN_WEAVES["plain"], {}, "backdrop"),
            (scene_xmls.TWILL_WV, scene_xmls.TWILL_PROPS, "floor")):
        r = float(scene_xmls.CLOTH_REPEAT[part])
        b.add_material(kind=mat.CLOTH, weave=cloth.parse_weave(text, props),
                       repeat_u=r, repeat_v=r)
    ct = cloth.pack_cloth([c[0] for c in b.cloth],
                          [(c[1], c[2]) for c in b.cloth], device=dev)
    return mat.pack_materials(b.materials, device=dev, cloth=ct)


def cloth_lanes_run(dev):
    """21b's lanes on `dev`: CLOTH_LANES uvs in [-2, 3]^2 over both weaves
    (numpy seed 21) through cloth_resolve, registry.gather and the
    family's eval_pdf and sample. Returns CPU tensors."""
    import numpy as np
    import torch
    from hairpt_torch.models.bsdf import cloth
    from hairpt_torch.models.bsdf import registry as mat
    table = cloth_material_table(dev)
    rs = np.random.RandomState(21)
    n = CLOTH_LANES
    uv = rs.uniform(-2, 3, (n, 2)).astype(np.float32)
    mid = rs.randint(0, 2, n).astype(np.int64)

    def dirs():
        d = rs.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d[:, 2] = np.abs(d[:, 2]) * np.where(rs.rand(n) < 0.1, -1, 1)
        return torch.as_tensor(d.astype(np.float32), device=dev)
    wi, wo = dirs(), dirs()
    u2 = torch.as_tensor(rs.rand(n, 2).astype(np.float32), device=dev)
    uv_t = torch.as_tensor(uv, device=dev)
    mid_t = torch.as_tensor(mid, device=dev)
    # gather's cloth stage is cloth_resolve on these lanes: its outputs
    # are the GatheredMat fields cloth.py maps
    gm = mat.gather(table, None, mid_t, uv_t)
    res = dict(cloth._cloth_res_from_gm(gm), kd=gm.diffuse, ks=gm.specular)
    f, pdf = cloth.Cloth.eval_pdf(gm, wi, wo, None)
    wo_s, wt, pdf_s, _, _ = cloth.Cloth.sample(gm, wi, None, u2, None, None)
    out = dict(spec_norm=table.cloth.spec_norm, f=f, pdf=pdf, wo_s=wo_s,
               wt=wt, pdf_s=pdf_s, **{f"res_{k}": v for k, v in res.items()})
    return {k: v.cpu() for k, v in out.items()}


def cloth_lanes_compare(c, p):
    """21b: the card's lanes (c) against the CPU's (p)."""
    import torch

    def rel(a, b):
        return (a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp(
            min=1e-30)
    sn = float(rel(c["spec_norm"], p["spec_norm"]).max())
    require(sn <= CLOTH_RESOLVE_RTOL, f"spec_norm card {c['spec_norm']} CPU "
            f"{p['spec_norm']}")
    worst = {}
    for k in c:
        if not k.startswith("res_"):
            continue
        if c[k].dtype == torch.bool:
            require(bool((c[k] == p[k]).all()), f"cloth_resolve {k} differs")
            continue
        worst[k[4:]] = float(rel(c[k], p[k]).max())
        require(worst[k[4:]] <= CLOTH_RESOLVE_RTOL,
                f"cloth_resolve {k}: {worst[k[4:]]}")
    f_ok = (rel(c["f"], p["f"]) <= CLOTH_F_RTOL).all(-1).float().mean()
    w_ok = (rel(c["wt"], p["wt"]) <= CLOTH_F_RTOL).all(-1).float().mean()
    pdf = max(float((c["pdf"] - p["pdf"]).abs().max()),
              float((c["pdf_s"] - p["pdf_s"]).abs().max()))
    wo = float((c["wo_s"] - p["wo_s"]).abs().max())
    live = float((p["f"].amax(-1) > 0).float().mean())
    log(f"21b cloth lanes ({CLOTH_LANES}, both weaves, uv in [-2, 3]^2): "
        f"spec_norm {c['spec_norm'].tolist()} (rel {sn:.3g}); resolve worst "
        f"rel {worst}; eval f within {CLOTH_F_RTOL} on {float(f_ok):.6f} of "
        f"the lanes ({live:.4f} nonzero), sample weight on {float(w_ok):.6f},"
        f" pdf max diff {pdf:.3g}, sampled wo max diff {wo:.3g}")
    require(f_ok >= CLOTH_F_SHARE and w_ok >= CLOTH_F_SHARE,
            f"cloth f agrees on {float(f_ok)}, weight on {float(w_ok)}")
    require(pdf <= CLOTH_PDF_ATOL, f"cloth pdf differs by {pdf}")
    return dict(spec_norm=sn, resolve=worst, f_share=float(f_ok),
                w_share=float(w_ok), pdf=pdf)


def cloth_small_run(dev, xml, small=SMALL21):
    """21b's small cloth render on `dev`: its image (on the CPU)."""
    from hairpt_torch.integrators import path
    from hairpt_torch.scene.xml_loader import load_scene
    s = load_scene(xml, spp_override=1, max_depth_override=small["depth"],
                   device=dev)
    img = path.render(s, spp=small["spp"]).cpu()
    mean = float(img.mean())
    require(bool(img.isfinite().all()) and mean > 0,
            f"small cloth on {dev}: mean {mean}")
    return img


def cloth_share(scene):
    """The share of a camera wave's lanes whose hit is cloth."""
    import torch
    from hairpt_torch.core import rng
    from hairpt_torch.integrators import common
    from hairpt_torch.models import sensors
    from hairpt_torch.models.bsdf import registry as mat
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    pixel = torch.arange(cfg.width * cfg.height, device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jitter = smp.next_2d(0)
    pos = torch.stack([(pixel % cfg.width).float() + jitter[:, 0],
                       (pixel // cfg.width).float() + jitter[:, 1]], -1)
    hit = common.scene_intersect(arr, sensors.sample_ray(scene.camera, pos),
                                 cfg.tiled_q)
    kind = arr.materials.kind[torch.clamp(hit.mat_id, min=0).long()]
    return float((hit.valid & (kind == mat.CLOTH)).float().mean())


def _stat(stderr, name):
    """A counter's value from the CLI's --stats table."""
    import re
    m = re.search(rf"-  {name}\s*: ([0-9,.]+)", stderr)
    require(m is not None, f"the CLI printed no '{name}':\n{stderr[-3000:]}")
    return float(m.group(1).replace(",", ""))


def _run_util(args, device):
    """Start `python -m hairpt_torch.cli util ...` (on the card, or with
    --cpu)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "hairpt_torch.cli", "util"] + list(args)
        + (["--cpu"] if device == "cpu" else []), cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait_util(proc, label):
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"util {label} exited {proc.returncode}:"
            f"\n{out[-3000:]}")


def cloth_cells(reset_all, device="cuda", res=1024, quality=HAIR_QUALITY,
                small=SMALL21):
    """Phase 21. The CPU sides of 21b in a subprocess (cpu_refs 'cloth')
    and the CLIs of 21c started first; beside them 21a: the cloth cell
    (scene_xmls.cloth, 1024^2, depth 65, hair quality 14) built, a
    warm-up wave and timed 1-spp waves (s/wave, tiled queries and A, B
    and F launches per wave), the share of camera lanes on cloth; 21b's
    card sides (cloth_resolve, eval_pdf and sample on CLOTH_LANES lanes,
    spec_norm, the small render) held against the CPU's; 21c: the banded
    CLI (--bands 64 --stats, at the CLIs' hair quality) against an
    in-process 1-spp path.render of the same scene (its EXR) and an
    in-process banded render (its 'Rays traced'), --profile's trace
    holding kernels A and B, util resample of the banded EXR to 512^2 on
    the card against --cpu, and the import command's XML rendered at 64^2
    on the card. device "cpu" rehearses it at a small res and quality."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="hairpt_cloth_") as tmp:
        return _cloth_cells(reset_all, device, res, quality, small, tmp)


def _cloth_cells(reset_all, device, res, quality, small, tmp):
    import numpy as np
    import torch
    from hairpt_torch.film.tiled import render_tiled_exr
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene import scene_xmls
    from hairpt_torch.scene.xml_loader import load_scene
    from hairpt_torch.utils import exr as exr_utils
    from hairpt_torch.utils import stats

    here = os.path.dirname(os.path.abspath(__file__))
    cuda = device == "cuda"
    t_all = time.time()
    xml = scene_xmls.write_scene(tmp, "cloth", res=res)
    small_xml = scene_xmls.write_scene(os.path.join(tmp, "small"), "cloth",
                                       res=small["res"], hair=False)
    refs = os.path.join(tmp, "cloth_refs.pt")
    err = open(os.path.join(tmp, "cloth_refs.stderr"), "w+")
    ref_proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-refs", refs,
         "cloth", small_xml], cwd=here, stdout=subprocess.DEVNULL,
        stderr=err)
    out = os.path.join(tmp, "out")
    cli_q = min(quality, CLI_HAIR_QUALITY)
    band_h = _cli_start(xml, os.path.join(out, "band.png"), quality, device,
                        spp=1, extra=["--bands", str(CLOTH_BANDS), "--stats"])
    prof_dir = os.path.join(out, "trace")
    prof_h = _cli_start(xml, os.path.join(out, "prof.png"), quality, device,
                        spp=1, res_scale=64 / res,
                        extra=["--profile", prof_dir, "--depth", "8"])
    os.makedirs(os.path.join(tmp, "imp"))
    dae = scene_xmls.write_dae(os.path.join(tmp, "imp", "props.dae"))
    imp_xml = os.path.join(tmp, "imp", "scene.xml")
    # the import command, then (the imported scene has no emitter) the
    # constant one of hairpt's own round trip (tests/test_collada.py)
    # grafted in, then the render: one chain of processes
    imp_h = _cli_start(imp_xml, os.path.join(out, "imp.png"), quality,
                       device, spp=1, res_scale=64 / 512, before=[
                           [sys.executable, "-m", "hairpt_torch.cli",
                            "import", dae, imp_xml],
                           [sys.executable, "-c", GRAFT_EMITTER, imp_xml]])
    facts = {}

    # ---- 21a: the full-width cell ----
    t0 = time.time()
    scene = load_scene(xml, hair_quality=quality, device=device)
    t_build = time.time() - t0
    share = cloth_share(scene)
    if cuda:
        progress, times, rays, n_timed = warm_up(scene, "cloth")
    else:
        times, rays, n_timed = [], [], 1

        def progress(done, total, secs_, n):
            times.append(secs_)
            rays.append(n)
    reset_all()
    itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
    if cuda:
        torch.cuda.synchronize()
    img = path.render(scene, spp=n_timed, seed=1, progress=progress)
    if cuda:
        torch.cuda.synchronize()
    launches = _ab_f(dict(tk.LAUNCHES, **ipk.LAUNCHES))
    off = dict(tk.OCT_LAUNCHES, **tk.SUB_LAUNCHES)
    plain = dict(tk.PLAIN_ON_CUDA, **ipk.PLAIN_ON_CUDA)
    queries = itiled.STATS["queries"]
    secs = sum(times) / len(times)
    n_rays = sum(rays) / len(rays)
    mean = _check_image(img, "cloth")
    del img
    facts.update(secs=secs, rays=n_rays, queries=queries / n_timed,
                 launches=launches, n_timed=n_timed, share=share,
                 build=t_build, mean=mean)
    log(f"21a cloth cell ({res}^2, depth 65, hair quality {quality}, built "
        f"in {t_build:.1f}s): {share:.4f} of the camera lanes on cloth; "
        f"{n_timed} timed waves: {secs:.3f} s/wave, {n_rays:.0f} rays/wave, "
        f"{n_rays / secs / 1e6:.4f} Mrays/s, {queries / n_timed:.1f} tiled "
        f"queries/wave, launches per wave "
        f"{ {k: v / n_timed for k, v in launches.items()} }; image mean "
        f"{mean:.6f}")
    require(share >= CLOTH_SHARE_MIN, f"only {share} of the camera lanes hit "
            f"cloth")
    if cuda:
        require(all(launches[k] > 0 for k in launches),
                f"the cloth waves did not launch A, B and F: {launches}")
        require(all(v == 0 for v in off.values()),
                f"the cloth waves ran an octet or subcull kernel: {off}")
        require(all(v == 0 for v in plain.values()),
                f"plain versions ran on CUDA tensors: {plain}")
    del scene

    # ---- 21b, the card's side ----
    t0 = time.time()
    card = None
    if cuda:
        card = dict(lanes=cloth_lanes_run("cuda"),
                    small=cloth_small_run("cuda", small_xml, small))
    log(f"21b on the card ({time.time() - t0:.1f}s)")

    # ---- 21c, in process: the CLIs' scene at 1 spp, monolithic and
    # banded ----
    t0 = time.time()
    s1 = load_scene(xml, hair_quality=cli_q, spp_override=1, device=device)
    ref_img = path.render(s1, spp=1, seed=0).cpu().numpy()
    stats.reset()
    band_ref = os.path.join(tmp, "band_ref.exr")
    render_tiled_exr(s1, band_ref, band_rows=CLOTH_BANDS, spp=1, seed=0)
    rays_in = stats._registry["Path tracer"]["Rays traced"].value
    del s1
    log(f"21c in process ({time.time() - t0:.1f}s): the 1-spp render and "
        f"the banded one ({rays_in:.0f} rays traced)")

    def exr_agrees(path_, label):
        got = exr_utils.read_exr(path_)[..., :3].astype(np.float64)
        want = ref_img.astype(np.float64)
        require(got.shape == want.shape and np.isfinite(got).all(),
                f"{label}: shape {got.shape} or non-finite")
        bad = np.abs(got - want) > EXR_RTOL * np.abs(want) + EXR_ATOL
        require(not bad.any(), f"{label}: {int(bad.sum())} values beyond "
                f"half rounding, worst {np.abs(got - want).max()}")
        return float(np.abs(got - want).max())
    d_in = exr_agrees(band_ref, "the in-process banded EXR")

    # ---- the CLIs ----
    wall, t_b, t_r, _ = _cli_wait(band_h, exts=("exr",))
    band_err = open(os.path.join(out, "band.stderr")).read()
    rays_cli = _stat(band_err, "Rays traced")
    d_cli = exr_agrees(os.path.join(out, "band.exr"), "the banded CLI's EXR")
    require(rays_cli == rays_in, f"the banded CLI traced {rays_cli} rays, "
            f"the in-process banded render {rays_in}")
    log(f"21c CLI --bands {CLOTH_BANDS} --stats ({res}^2, hair quality "
        f"{cli_q}): exit 0 in {wall:.1f}s wall, built in {t_b}s, rendered "
        f"in {t_r}s; its EXR within {d_cli:.3g} of the in-process 1-spp "
        f"render (the in-process banded EXR within {d_in:.3g}); Rays traced "
        f"{rays_cli:.0f} = in process")
    facts.update(cli_band=dict(wall=wall, build=t_b, render=t_r,
                               rays=rays_cli))
    band_exr = os.path.join(out, "band.exr")
    utils = [(dev_, _run_util(["resample", band_exr, "-o",
                               os.path.join(out, f"rs_{dev_}.npy"),
                               "--size", f"{RESAMPLE_SIZE}x{RESAMPLE_SIZE}"],
                              dev_))
             for dev_ in (("cuda", "cpu") if cuda else ("cpu",))]
    wall, t_b, t_r, _ = _cli_wait(prof_h)
    with open(os.path.join(prof_dir, "trace.json")) as fh:
        names = [e.get("name", "") for e in json.load(fh).get(
            "traceEvents", [])]
    n_a = sum("cull_kernel" in n for n in names)
    n_b = sum("phase_b_kernel" in n for n in names)
    log(f"21c CLI --profile (64^2): exit 0 in {wall:.1f}s wall, rendered in "
        f"{t_r}s; its trace holds {len(names)} events, {n_a} of kernel A "
        f"(cull_kernel) and {n_b} of kernel B (phase_b_kernel)")
    if cuda:
        require(n_a > 0 and n_b > 0, "the profiler trace holds no launch of "
                "kernel A or B")
    facts.update(profile=dict(wall=wall, events=len(names), a=n_a, b=n_b))
    wall, t_b, t_r, img_i = _cli_wait(imp_h)
    mean_i = float(img_i.mean())
    require(np.isfinite(img_i).all() and mean_i > 0 and img_i.shape[:2] ==
            (64, 64), f"the imported scene's image: {img_i.shape}, mean "
            f"{mean_i}")
    log(f"21c import and a 64^2 render of the imported scene: exit 0 in "
        f"{wall:.1f}s wall; image mean {mean_i:.6f}")
    for dev_, proc in utils:
        _wait_util(proc, f"resample on {dev_}")
    rs = {dev_: np.load(os.path.join(out, f"rs_{dev_}.npy"))
          for dev_, _ in utils}
    rs_c = rs[utils[0][0]]
    require(rs_c.shape == (RESAMPLE_SIZE, RESAMPLE_SIZE, 3)
            and np.isfinite(rs_c).all(), f"resample: {rs_c.shape}")
    if cuda:
        d = np.abs(rs["cuda"].astype(np.float64) - rs["cpu"])
        tol = RESAMPLE_RTOL * np.abs(rs["cpu"]) + 1e-6 * np.abs(
            rs["cpu"]).max()
        log(f"21c util resample to {RESAMPLE_SIZE}^2: card against --cpu max "
            f"diff {d.max():.3g} (the largest value "
            f"{np.abs(rs['cpu']).max():.4g})")
        require((d <= tol).all(), f"util resample card and CPU differ by "
                f"{d.max()}")

    # ---- 21b, the CPU's side ----
    try:
        rc = ref_proc.wait(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    err.seek(0)
    msg = err.read()
    err.close()
    require(rc == 0, f"the cloth CPU references exited {rc}:\n{msg[-3000:]}")
    log(f"21b CPU references in a subprocess: {time.time() - t_all:.1f}s "
        f"wall after the phase began")
    if card is not None:
        ref = torch.load(refs, weights_only=False)
        facts["lanes"] = cloth_lanes_compare(card["lanes"], ref["lanes"])
        a, b = card["small"], ref["small"]
        rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        d = (a - b).abs().amax(-1).flatten()
        close = float(((a - b).abs() <= 1e-3 * b.abs() + 1e-4).all(-1)
                      .float().mean())
        worst = torch.argsort(d, descending=True)[:3].tolist()
        log(f"21b small cloth ({small['res']}^2, depth {small['depth']}, no "
            f"hair, {small['spp']} spp): image mean "
            f"card {float(a.mean()):.6f}, CPU {float(b.mean()):.6f}, rel "
            f"diff {rel:.3g}; {close:.4f} of the pixels within 1e-3; the "
            f"largest differences (card, CPU) at pixels "
            + ", ".join(f"{i}: ({float(a.flatten(0, 1)[i].mean()):.3f}, "
                        f"{float(b.flatten(0, 1)[i].mean()):.3f})"
                        for i in worst))
        require(rel <= MEAN_RTOL, f"small cloth: card and CPU differ by {rel}")
    log(f"phase 21b-21c ({time.time() - t_all:.1f}s): ok")
    return facts


# ---------------------------------------------------------------------------
# phase 22: the image codecs, the film's annotations and banner, and the
# leftovers (core/distribution, core/numerics, spectrum's helpers,
# make_li_fn's ablate), through kernels A and B (no new kernel: the JPEG
# block stage is integer tensor code, the leftovers are tensor code)
# ---------------------------------------------------------------------------

# 22a: the annotated CLI's labels (one with film, sampler and integrator
# keys, one with the render time, whose digits only the CLI knows). A box:
# the label's 6 x 11 cells, a column either side and 14 rows
# (utils/font.py).
# 22a, 22b: the decoded JPEG against its source outside the text's boxes,
# PSNR in dB. Quality 95 with 4:2:0 chroma on a 1-spp frame: the hair's
# pixels are noise, whose red chroma the 2 x 2 subsampling averages away
# (tests/test_torch_annotate.py: 30.0 dB on a 64^2 frame that hair fills;
# a 128^2 CPU rehearsal: 28.1 dB, the hair's pixels 24.1 dB with a red
# RMSE of 12.9 levels, the sky's 40.1 dB). The encoder writes libjpeg's
# bytes (tests/test_torch_jpeg.py), so the bound is the codec's loss on
# such a frame, not the port's
ANNOT_LABELS = (
    (8, 8, "$film['width']x$film['height'] spp "
           "$sampler['sampleCount'] depth $integrator['maxDepth']"),
    (8, 24, "t=$scene['renderTime']s"))
RENDER_TIME = "$scene['renderTime']"
JPEG_PSNR_MIN = 25.0
# 22c: make_li_fn's ablate knobs on phase 4's scene, a warm-up round and
# ABLATE_ROUNDS timed rounds of one 1-spp wave for each set in turn (the
# first, no knob, the baseline)
ABLATE_SETS = ((), ("nonee",), ("noshadow",), ("cheapshade",), ("nosort",))
ABLATE_ROUNDS = 4
# 22d: lanes of the leftovers' card-against-CPU check; the CDF rounding
# (in ulps of 1) that u_rescaled may carry divided by its bin's probability
LEFTOVER_LANES = 1 << 20
CDF_ULPS = 64


def annotated_xml(tmp, res):
    """Phase 11's furball XML with ANNOT_LABELS and the banner in its
    film."""
    from hairpt_torch.scene import scene_xmls
    xml = scene_xmls.write_scene(tmp, "furball", res=res)
    labels = "".join(f'<string name="label[{x}, {y}]" value="{t}"/>'
                     for x, y, t in ANNOT_LABELS)
    src = open(xml).read()
    film_end = '<rfilter type="tent"/></film>'
    require(film_end in src, "the furball XML's film has no tent filter")
    with open(xml, "w") as f:
        f.write(src.replace(film_end, labels + '<boolean name="banner" '
                            'value="true"/>' + film_end))
    return xml


def _text_boxes(labels, subst, h, w, banner):
    import numpy as np
    from hairpt_torch.utils import font
    boxes = [(x - 1, x + font.text_width(font.substitute(t, subst)) + 1, y,
              y + 14) for x, y, t in labels]
    if banner:
        tw = font.text_width("hairpt")
        boxes.append((w - tw - 5, w, h - 14, h))
    inside = np.zeros((h, w), bool)
    for x0, x1, y0, y1 in boxes:
        inside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    return boxes, inside


def label_drawn(dec, src, x, y, text):
    """Whether `text`, drawn white at (x, y), shows in the decoded JPEG
    `dec` of the annotated frame whose tonemapped source without the text
    is `src`: the mean luma of its glyph pixels
    is >= 240 and has risen over the source's by half its headroom to
    white, at most 8 levels. 4:2:0 blurs a 1-pixel white stroke's chroma
    into its neighbours', so no channel test holds on a bright sky; the
    luma keeps full resolution. Returns (drawn, decoded luma, source
    luma)."""
    import numpy as np
    from hairpt_torch.utils import font
    h, w = dec.shape[:2]
    mask = np.zeros((h, w, 3), np.uint8)
    font.draw_text(mask, x, y, text, (255, 255, 255))
    mask = mask[..., 0] > 0
    lum = np.array([0.299, 0.587, 0.114])
    yd = float((np.asarray(dec, np.float64) @ lum)[mask].mean())
    ys = float((np.asarray(src, np.float64) @ lum)[mask].mean())
    drawn = yd >= 240.0 and yd - ys >= min(8.0, (255.0 - ys) / 2)
    return drawn, round(yd, 2), round(ys, 2)


def psnr(a, b, mask=None):
    import numpy as np
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2
    mse = (d[mask] if mask is not None else d).mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def annotated_cli_start(tmp, device="cuda", res=1024, quality=HAIR_QUALITY):
    """22a, started beside phase 21: the CLI on the annotated furball XML,
    1 spp, --stats, -o furball.jpg."""
    xml = annotated_xml(tmp, res)
    return _cli_start(xml, os.path.join(tmp, "out", "furball.jpg"), quality,
                      device, spp=1, extra=["--stats"])


def annotated_cli_check(handle, device="cuda"):
    """22a's checks: exit 0, Rays traced > 0, A's and B's launches in its
    log, the JPEG decoded on the card against the tonemapped .npy outside
    the text (JPEG_PSNR_MIN), each label's glyphs shown (label_drawn; the
    render time's digits unknown, its label's text before them). Returns the
    facts and the 8-bit tonemapped frame for 22b."""
    import numpy as np
    import ast
    import re
    from hairpt_torch.utils import font
    from hairpt_torch.utils import io as io_utils
    from hairpt_torch.utils import jpeg
    wall, t_b, t_r, img = _cli_wait(handle, exts=("jpg", "exr", "npy",
                                                  "pfm"))
    out = handle[2]
    stderr = open(out[:-4] + ".stderr").read()
    rays = _stat(stderr, "Rays traced")
    require(rays > 0, "the annotated CLI traced no ray")
    m = re.search(r"kernel launches: (\{.*\})", stderr)
    launched = ast.literal_eval(m.group(1)) if m else {}
    if device == "cuda":
        require(launched.get("cull_phase_a", 0) > 0
                and launched.get("phase_b", 0) > 0,
                f"the annotated CLI's log shows no launch of A and B: "
                f"{launched}")
    h, w = img.shape[:2]
    # the render time's digits are not known here: a box as wide as
    # 9,999.99 s needs
    subst = {"film.width": w, "film.height": h, "sampler.sampleCount": 1,
             "integrator.maxDepth": 65, "scene.renderTime": 9999.99}
    boxes, inside = _text_boxes(ANNOT_LABELS, subst, h, w, True)
    t0 = time.time()
    dec = jpeg.read_jpeg(out, device).cpu().numpy()
    t_dec = time.time() - t0
    tm = np.clip(io_utils.tonemap_srgb(img, 2.2) * 255.0, 0, 255)
    q = psnr(dec, tm, ~inside)
    drawn = [label_drawn(dec, tm, x, y, font.substitute(
        t.split(RENDER_TIME)[0], subst)) for x, y, t in ANNOT_LABELS]
    log(f"22a CLI render -o furball.jpg --stats ({w}x{h}, 1 spp, two labels "
        f"and the banner): exit 0 in {wall:.1f}s wall, built in {t_b}s, "
        f"rendered in {t_r}s; Rays traced {rays:.0f}; launches {launched}; "
        f"the JPEG ({os.path.getsize(out)} bytes) decoded on the card in "
        f"{t_dec:.3f}s: PSNR {q:.2f} dB against the tonemapped .npy outside "
        f"the text ({int(inside.sum())} pixels inside); the labels' glyph "
        f"luma (decoded, source) {[d[1:] for d in drawn]}")
    require(np.isfinite(img).all() and img.mean() > 0, "the annotated "
            "CLI's image is not finite and positive")
    require(q >= JPEG_PSNR_MIN, f"the CLI's JPEG: PSNR {q:.2f} dB < "
            f"{JPEG_PSNR_MIN}")
    require(all(d[0] for d in drawn), f"a label does not show in the JPEG: "
            f"glyph luma (decoded, source) {[d[1:] for d in drawn]}")
    u8 = np.clip(io_utils.tonemap_srgb(img, 2.2) * 255.0 + 0.5, 0, 255) \
        .astype(np.uint8)
    return dict(wall=wall, build=t_b, render=t_r, rays=rays, psnr=q,
                launches=launched), u8


def codec_sides(u8, tmp, devices=("cuda", "cpu")):
    """22b: write_jpg of the frame on each device (byte-identical files),
    read_image of that file on each (the same pixels), the decode against
    the source (JPEG_PSNR_MIN); encode and decode seconds per side."""
    import numpy as np
    from hairpt_torch.utils import io as io_utils
    facts, files, pix = {}, {}, {}
    for dev in devices:
        p = os.path.join(tmp, f"frame_{dev}.jpg")
        t0 = time.time()
        io_utils.write_jpg(p, u8, device=dev)
        t_enc = time.time() - t0
        files[dev] = open(p, "rb").read()
        t0 = time.time()
        pix[dev] = io_utils.read_image(p, device=dev)
        t_dec = time.time() - t0
        facts[dev] = dict(encode=t_enc, decode=t_dec)
    ref = devices[0]
    same_bytes = all(files[d] == files[ref] for d in devices)
    same_pix = all(np.array_equal(pix[d], pix[ref]) for d in devices)
    q = psnr(np.round(pix[ref] * 255.0), u8)
    log(f"22b write_jpg / read_image of a {u8.shape[1]}x{u8.shape[0]} frame "
        f"({len(files[ref])} bytes): "
        + "; ".join(f"{d}: encode {facts[d]['encode']:.3f}s, decode "
                    f"{facts[d]['decode']:.3f}s" for d in devices)
        + f"; files byte-identical {same_bytes}, pixels equal {same_pix}; "
          f"PSNR against the source {q:.2f} dB")
    require(same_bytes, "write_jpg on the card and on the CPU wrote "
            "different bytes")
    require(same_pix, "read_image on the card and on the CPU differ")
    require(q >= JPEG_PSNR_MIN, f"the JPEG's decode: PSNR {q:.2f} dB")
    facts["psnr"] = q
    return facts


def ablate_waves(scene, reset_all, phase4_secs):
    """22c: a warm-up round, then ABLATE_ROUNDS timed rounds, of one 1-spp
    wave of make_li_fn(scene, ablate=knobs) for each entry of ABLATE_SETS
    in turn, so that every round holds each knob set beside its own
    no-knob baseline (the first). Per knob set: the median s/wave and the median of the rounds'
    ratios to their baseline, each with its least and most; one wave's
    rays, tiled queries and A's and B's launches; a finite image every
    wave."""
    import statistics
    import torch
    from hairpt_torch.film import film as film_mod
    from hairpt_torch.integrators import path
    from hairpt_torch.integrators.common import block_swizzle
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk
    cfg = scene.config
    dev = scene.arrays.device
    n_pix = cfg.width * cfg.height
    swz = block_swizzle(cfg.width, cfg.height)
    pixel_idx = torch.as_tensor(swz, device=dev) if swz is not None \
        else torch.arange(n_pix, device=dev)
    sample_idx = torch.full((n_pix,), 1 + 65536, dtype=torch.int64,
                            device=dev)
    lis = {knobs: path.make_li_fn(scene, ablate=knobs)
           for knobs in ABLATE_SETS}
    secs = {knobs: [] for knobs in ABLATE_SETS}
    facts = {}
    for rnd in range(ABLATE_ROUNDS + 1):
        for knobs in ABLATE_SETS:
            name = "+".join(knobs) or "none"
            reset_all()
            itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.time()
            rad, pos, n_rays = lis[knobs](scene.arrays, pixel_idx,
                                          sample_idx)
            n_rays = float(n_rays)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if rnd:
                secs[knobs].append(time.time() - t0)
            img, wt = film_mod.zeros(scene.film, dev)
            img, wt = film_mod.splat_samples(scene.film, pos, rad, img, wt)
            img = film_mod.develop(img, wt)
            require(bool(torch.isfinite(img).all()),
                    f"ablate={name}: non-finite pixels")
            facts[knobs] = dict(rays=n_rays,
                                queries=itiled.STATS["queries"],
                                launches=dict(tk.LAUNCHES),
                                mean=float(img.mean()))
            del rad, pos, img, wt
    out = {}
    for knobs in ABLATE_SETS:
        name = "+".join(knobs) or "none"
        s, f = secs[knobs], facts[knobs]
        ratio = [a / b for a, b in zip(s, secs[()])]
        out[name] = dict(secs=statistics.median(s), secs_min=min(s),
                         secs_max=max(s), secs_all=s,
                         ratio=statistics.median(ratio),
                         ratio_min=min(ratio), ratio_max=max(ratio), **f)
        log(f"22c ablate={name}: median {out[name]['secs']:.4f} s/wave "
            f"({min(s):.4f}-{max(s):.4f} over {len(s)} waves), "
            f"{out[name]['ratio']:.3f}x its round's no-knob wave "
            f"({min(ratio):.3f}-{max(ratio):.3f}); {f['rays']:.0f} rays, "
            f"{f['queries']} tiled queries, launches {f['launches']}, image "
            f"mean {f['mean']:.6f} (phase 4: {phase4_secs:.3f} s/wave)")
    return out


def leftovers_run(dev, n=LEFTOVER_LANES):
    """22d's computations on `dev`: core/distribution, core/numerics and
    spectrum's helpers on n lanes (inputs from a numpy seed)."""
    import numpy as np
    import torch
    from hairpt_torch.core import distribution as dist
    from hairpt_torch.core import numerics as num
    from hairpt_torch.core import spectrum as spec
    rng = np.random.default_rng(22)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    w = rng.random((64,)).astype(np.float32) ** 3
    u = t(rng.random(n))
    cdf, _ = dist.build_cdf(t(w))
    out = {"cdf": cdf, "u": u}
    out["idx"], out["prob"], out["ur"] = dist.sample_discrete(
        cdf.expand(n, 64), u)
    out["pdf"] = dist.pdf_continuous(cdf.expand(n, 64), u)
    icdf = dist.InterpolatedCdf1D(rng.random((9, 13)), device=dev)
    v = t(rng.random(n) * 8.5 - 0.2)
    out["i_idx"], out["i_ur"], out["i_p"] = icdf.sample(v, u)
    c = t(rng.random(n) * 7 + 0.1)
    out["brent"] = num.brent_solve(lambda x: x ** 3 - c, torch.zeros_like(c),
                                   torch.full_like(c, 2.5))
    vals = (np.sin(np.linspace(0, 5, 23)) + 1.3).astype(np.float32)
    out["cubic"] = num.eval_cubic_1d(t(rng.random(n) * 2.6 - 0.3), vals,
                                     0.0, 2.0)
    out["cubic_x"], out["cubic_pdf"] = num.sample_cubic_1d(u, vals, 0.0, 2.0)
    th = t(rng.random(n) * (np.pi - 0.1) + 0.05)
    ph = t(rng.random(n) * 2 * np.pi)
    out["sh"] = num.sh_eval_basis(4, th, ph)
    rgb = t(rng.random((n, 3)) * 1.4 - 0.2)
    out["lum"] = spec.luminance(rgb)
    out["srgb"] = spec.srgb_gamma(rgb)
    out["inv_srgb"] = spec.inv_srgb_gamma(rgb)
    out["gamma"] = spec.gamma_encode(rgb, 2.2)
    out["bb"] = spec.blackbody_rgb(t(rng.random(n) * 20000 + 800))
    return {k: x.cpu() for k, x in out.items()}


def leftovers_cell(devices=("cuda", "cpu")):
    """22d: leftovers_run on the card against the CPU, with the CPU tests'
    bounds (tests/test_torch_numerics.py): a sampled bin equal but where
    the lane's u lies within 1 ulp of a CDF step (the interpolated CDF's
    on >= 99% of the lanes), floats within 1e-6 absolute plus 1e-6
    relative (where the bins agree; blackbody_rgb reaches 3 and its
    powf and logf differ by a few ulps between the card and the CPU, as
    the CPU test's 1e-6 relative allows), the cubic pdf within 1e-5
    relative, the SH basis within 1e-5 of its largest magnitude. The card's cumsum rounds otherwise than the
    CPU's (the CPU tests' two sides round alike): the CDF is held within
    1e-6 + CDF_ULPS ulps of 1, a bin's probability (hi - lo) within twice
    that, the piecewise-constant pdf (its probability times the 64 bins)
    within 64 times that, and u_rescaled = (u - lo) / prob within that
    divided by the bin's probability."""
    import numpy as np
    import torch
    t0 = time.time()
    card = leftovers_run(devices[0])
    t_card = time.time() - t0
    cpu = leftovers_run(devices[1])
    cdf_tol = CDF_ULPS * 2.0 ** -24
    worst = {}
    for k in card:
        a, b = card[k], cpu[k]
        if not a.is_floating_point():
            worst[k] = float((a != b).double().mean())
            continue
        d = (a.double() - b.double()).abs()
        if k == "sh":
            tol = 1e-5 * float(b.abs().max())
        elif k == "cubic_pdf":
            tol = 1e-5 * b.abs().double()
        elif k in ("ur", "i_ur"):
            prob = cpu["prob" if k == "ur" else "i_p"].double()
            tol = 1e-6 + 2 * cdf_tol / prob.clamp(min=1e-30)
        elif k == "cdf":
            tol = 1e-6 + cdf_tol
        elif k in ("prob", "i_p"):
            tol = 1e-6 + 2 * cdf_tol
        elif k == "pdf":
            tol = 1e-6 + 2 * cdf_tol * cpu["cdf"].shape[-1]
        else:
            tol = 1e-6 * (1.0 + b.abs().double())
        same = torch.ones_like(d, dtype=torch.bool)
        if k in ("prob", "ur"):
            same = card["idx"] == cpu["idx"]
        elif k in ("i_ur", "i_p"):
            same = (card["i_idx"] == cpu["i_idx"])
        worst[k] = float(d[same].max()) if bool(same.any()) else 0.0
        require(not bool(((d > tol) & same).any()),
                f"22d {k}: card and CPU differ by {worst[k]}")
    lanes = torch.nonzero(card["idx"] != cpu["idx"]).flatten().numpy()
    u = cpu["u"].numpy()[lanes].astype(np.float32)
    cdf = cpu["cdf"].numpy()
    near = (np.abs(cdf[None, :] - u[:, None])
            <= np.spacing(u)[:, None]).any(-1)
    require(near.all(), f"22d: {int((~near).sum())} lanes pick another bin "
            f"away from a CDF step")
    require(worst["i_idx"] <= 0.01, f"22d: the interpolated CDF picks "
            f"another bin on {worst['i_idx']} of the lanes")
    log(f"22d leftovers on {LEFTOVER_LANES} lanes card against CPU (card "
        f"{t_card:.2f}s): {len(lanes)} bins differ, each at a CDF step; "
        f"largest differences " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in worst.items()))
    return worst


# ---------------------------------------------------------------------------
# phase 23: the image formats the JAX package reads and writes through PIL
# (TIFF, GIF, WebP, Netpbm, the JPEG variants PIL decodes) and the
# integrator and film types it does not know, through kernels A, B and F
# (no new kernel: the readers run on the host; a JPEG's block stage is
# integer tensor code on the card)
# ---------------------------------------------------------------------------

# the committed fixtures (tests/torch_images/make_fixtures.py writes them
# with PIL, which the card's machine lacks) and PIL's arrays of them
IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "torch_images")
# the scene textures: the floor's LZW TIFF (predictor 2) bitmap and
# lossless WebP normal map, the backdrop's GIF, the heightfield's
# arithmetic-coded JPEG, the lossy WebP envmap (23c's, 128 x 64)
TEXTURES23 = ("lzw_pred2.tif", "normal_lossless.webp", "backdrop.gif",
              "height_arith.jpg", "env_lossy.webp")
# 23a's envmap, of a size users have: 1024 x 512 (large.json)
ENV23A = "env_1k.webp"
# 23c: the small card-against-CPU render of 23a's XML
SMALL23 = dict(res=64, quality=0.1, depth=8)
TEXTURED_FLOOR = (
    "<bsdf type=\"normalmap\" id=\"floor23\"><texture type=\"bitmap\" "
    "name=\"normals\"><string name=\"filename\" value=\"{1}\"/></texture>"
    "<bsdf type=\"twosided\"><bsdf type=\"diffuse\"><texture "
    "type=\"bitmap\" name=\"reflectance\"><string name=\"filename\" "
    "value=\"{0}\"/><float name=\"uscale\" value=\"4\"/><float "
    "name=\"vscale\" value=\"4\"/></texture></bsdf></bsdf></bsdf>"
    "<bsdf type=\"twosided\" id=\"backdrop23\"><bsdf type=\"diffuse\">"
    "<texture type=\"bitmap\" name=\"reflectance\"><string "
    "name=\"filename\" value=\"{2}\"/></texture></bsdf></bsdf>"
    "<bsdf type=\"diffuse\" id=\"ground23\"><rgb name=\"reflectance\" "
    "value=\"0.5, 0.45, 0.4\"/></bsdf>"
    "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
    "value=\"8\"/><rotate x=\"1\" angle=\"-90\"/><translate y=\"7\"/>"
    "</transform><ref id=\"floor23\"/></shape>"
    "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale x=\"6\" "
    "y=\"3\"/><rotate y=\"1\" angle=\"-45\"/><translate x=\"12\" "
    "y=\"16\" z=\"-6\"/></transform><ref id=\"backdrop23\"/></shape>"
    "<shape type=\"heightfield\"><string name=\"filename\" value=\"{3}\"/>"
    "<float name=\"scale\" value=\"1\"/><transform name=\"toWorld\"><scale "
    "x=\"2.5\" y=\"2.5\" z=\"1\"/><rotate x=\"1\" angle=\"-90\"/><translate "
    "x=\"-1\" y=\"7\" z=\"2\"/></transform><ref id=\"ground23\"/></shape>")


def textured_xml(tmp, res, env=TEXTURES23[4]):
    """Phase 11's furball XML under the lossy WebP envmap `env`, over a
    floor (LZW TIFF bitmap in a lossless WebP normal map), a GIF backdrop
    and an arithmetic-coded JPEG heightfield; the textures copied beside
    it."""
    import shutil
    from hairpt_torch.scene import scene_xmls
    emitter = (f"<emitter type=\"envmap\"><string name=\"filename\" "
               f"value=\"{env}\"/></emitter>")
    xml = scene_xmls.write_scene(tmp, "furball", res=res, emitter=emitter)
    for name in TEXTURES23[:4] + (env,):
        shutil.copy(os.path.join(IMAGES, name), os.path.dirname(xml))
    src = open(xml).read()
    require(src.count("</scene>") == 1, "the furball XML has no </scene>")
    with open(xml, "w") as f:
        f.write(src.replace("</scene>", TEXTURED_FLOOR.format(*TEXTURES23)
                            + "</scene>"))
    return xml


def textured_cli_start(tmp, device="cuda", res=1024, quality=HAIR_QUALITY):
    """23a, started beside phase 21 as 22a is: the CLI on textured_xml
    under the 1024 x 512 envmap, 1 spp, --stats, -o frame.tif; and 23b's
    decode of the large fixtures, a process of its own beside it. Returns
    both handles."""
    xml = textured_xml(tmp, res, ENV23A)
    cli = _cli_start(xml, os.path.join(tmp, "out", "frame.tif"), quality,
                     device, spp=1, extra=["--stats"])
    out = os.path.join(tmp, "large.json")
    here = os.path.dirname(os.path.abspath(__file__))
    large = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--large-fixtures", out, device], cwd=here,
                             stdout=subprocess.DEVNULL)
    return cli, (large, out)


def large_fixtures_worker(out, device="cuda"):
    """The fixtures of a size users have (tests/torch_images/large.json),
    each read by the port as the loader reads it; writes to `out` per
    file its seconds, pixels and whether its shape and the SHA-256 of its
    uint8 array equal PIL's."""
    import hashlib
    import numpy as np
    from hairpt_torch.utils import io as io_utils
    with open(os.path.join(IMAGES, "large.json")) as f:
        want = json.load(f)
    res = {}
    for name in sorted(want):
        t0 = time.time()
        got = io_utils.read_ldr(os.path.join(IMAGES, name), device=device)
        secs = time.time() - t0
        digest = hashlib.sha256(np.ascontiguousarray(got).tobytes())
        res[name] = dict(s=secs, px=int(got.shape[0] * got.shape[1]),
                         equal=list(got.shape) == want[name]["shape"]
                         and digest.hexdigest() == want[name]["sha256"])
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def large_fixtures_check(handle):
    """23b's check of large_fixtures_worker: exit 0, every file equal to
    PIL's array; the seconds per file and per megapixel."""
    proc, out = handle
    try:
        rc = proc.wait(timeout=600)
    finally:
        _stop(proc)
    require(rc == 0, f"the large fixtures' decode exited {rc}")
    with open(out) as f:
        res = json.load(f)
    log("23b large fixtures decoded on the host in a process of their own: "
        + ", ".join(f"{k} {v['px']} px in {v['s']:.3f}s "
                    f"({v['s'] / v['px'] * 1e6:.3f} s/Mpx), equal to PIL's: "
                    f"{v['equal']}" for k, v in res.items()))
    require(res and all(v["equal"] for v in res.values()),
            f"large fixtures that do not decode as PIL does: {res}")
    return res


def textured_cli_check(handle, device="cuda"):
    """23a's checks: exit 0, Rays traced > 0, A's, B's and F's launches in
    its log, and the port's TIFF reader giving back exactly the 8-bit
    tonemapped frame the render wrote."""
    import ast
    import re
    import numpy as np
    from hairpt_torch.utils import io as io_utils
    wall, t_b, t_r, img = _cli_wait(handle, exts=("tif", "exr", "npy",
                                                  "pfm"))
    out = handle[2]
    stderr = open(out[:-4] + ".stderr").read()
    # the loader's line per texture: its size and decode seconds
    decoded = {os.path.basename(m.group(1)): (int(m.group(2)),
                                              int(m.group(3)),
                                              float(m.group(4)))
               for m in re.finditer(r"image (\S+): (\d+)x(\d+) decoded in "
                                    r"([0-9.]+) s", stderr)}
    require(len(decoded) == 5, f"the textured CLI logged the decode of "
            f"{sorted(decoded)}, not its five textures")
    rays = _stat(stderr, "Rays traced")
    require(rays > 0, "the textured CLI traced no ray")
    m = re.search(r"kernel launches: (\{.*\})", stderr)
    launched = ast.literal_eval(m.group(1)) if m else {}
    if device == "cuda":
        abf = _ab_f(launched)
        require(abf["cull_phase_a"] > 0 and abf["phase_b"] > 0
                and abf["packed_tri_closest"] > 0,
                f"the textured CLI's log shows no launch of A, B and F: "
                f"{launched}")
    require(np.isfinite(img).all() and img.mean() > 0, "the textured "
            "CLI's image is not finite and positive")
    t0 = time.time()
    frame = io_utils.read_ldr(out)
    t_read = time.time() - t0
    want = np.clip(io_utils.tonemap_srgb(img, 2.2) * 255.0 + 0.5, 0, 255) \
        .astype(np.uint8)
    same = frame.shape == want.shape and bool((frame == want).all())
    h, w = img.shape[:2]
    log(f"23a CLI render -o frame.tif --stats ({w}x{h}, 1 spp; TIFF, WebP, "
        f"GIF and arithmetic JPEG textures): exit 0 in {wall:.1f}s wall, "
        f"built in {t_b}s (textures decoded in "
        f"{sum(v[2] for v in decoded.values()):.3f}s: "
        + ", ".join(f"{k} {v[0]}x{v[1]} {v[2]:.3f}s"
                    for k, v in decoded.items())
        + f"), rendered in {t_r}s; Rays traced {rays:.0f}; "
        f"launches {launched}; frame.tif ({os.path.getsize(out)} bytes) read "
        f"back in {t_read:.3f}s, equal to the tonemapped .npy: {same}")
    require(same, "the TIFF the CLI wrote does not read back as the frame "
            "it rendered")
    return dict(wall=wall, build=t_b, render=t_r, rays=rays,
                launches=launched, decoded=decoded)


def fixture_decodes(devices=("cuda", "cpu")):
    """23b: every committed fixture read on the card machine equals PIL's
    committed array bit for bit; the JPEG block stage (the .jpg files and
    the JPEG-compressed TIFF) on the card equals the CPU's; the decode
    seconds per file."""
    import numpy as np
    from hairpt_torch.utils import io as io_utils
    with np.load(os.path.join(IMAGES, "expected.npz")) as npz:
        want = {k: npz[k] for k in npz.files}
    require(len(want) >= 30, f"only {len(want)} image fixtures")
    secs, bad = {}, []
    for name in sorted(want):
        p = os.path.join(IMAGES, name)
        t0 = time.time()
        got = io_utils.read_ldr(p, device=devices[0])
        secs[name] = time.time() - t0
        if got.shape != want[name].shape or not (got == want[name]).all():
            bad.append(name)
        if len(devices) > 1 and (name.endswith(".jpg")
                                 or name == "jpeg_ycbcr.tif"):
            other = io_utils.read_ldr(p, device=devices[1])
            if not (other == got).all():
                bad.append(f"{name} ({devices[0]} against {devices[1]})")
    slow = sorted(secs.items(), key=lambda kv: -kv[1])
    log(f"23b {len(want)} fixtures decoded in {sum(secs.values()):.3f}s on "
        f"the host (block stage on {devices[0]}); slowest "
        + ", ".join(f"{k} {v:.3f}s" for k, v in slow[:6])
        + "; per file " + json.dumps({k: round(v, 4) for k, v in
                                      secs.items()}))
    require(not bad, f"fixtures that do not decode as PIL does: {bad}")
    return secs


def textured_small(tmp, device="cuda", small=SMALL23):
    """23c: textured_xml at small["res"]^2 loaded and rendered on the card
    and with the plain versions on the CPU: every texture table (the
    bitmaps' and the envmap's) equal, the images' means within
    MEAN_RTOL."""
    import torch
    from hairpt_torch.integrators import path as path_int
    from hairpt_torch.scene.xml_loader import load_scene
    xml = textured_xml(tmp, small["res"])
    devs = ("cuda", "cpu") if device == "cuda" else ("cpu",)
    scenes, means = {}, {}
    for dev in devs:
        s = load_scene(xml, hair_quality=small["quality"], spp_override=1,
                       max_depth_override=small["depth"], device=dev)
        img = path_int.render(s, spp=1)
        means[dev] = float(img.mean())
        require(bool(img.isfinite().all()) and means[dev] > 0,
                f"small textured render on {dev}: mean {means[dev]}")
        scenes[dev] = s
    tables = {}
    for part in ("checkers", "env"):
        for f in getattr(scenes[devs[0]].arrays, part)._fields:
            a = getattr(getattr(scenes[devs[0]].arrays, part), f)
            if torch.is_tensor(a):
                tables[f"{part}.{f}"] = [getattr(getattr(scenes[d].arrays,
                                                         part), f).cpu()
                                         for d in devs]
    unequal = [k for k, v in tables.items()
               if any(not torch.equal(v[0], x) for x in v[1:])]
    rel = 0.0
    if len(devs) > 1:
        rel = abs(means["cuda"] - means["cpu"]) / means["cpu"]
    log(f"23c textured XML at {small['res']}^2 (hair quality "
        f"{small['quality']}, depth {small['depth']}, 1 spp): image mean "
        + ", ".join(f"{d} {means[d]:.6f}" for d in devs)
        + f", rel diff {rel:.3g}; {len(tables)} texture tables, unequal "
          f"{unequal}")
    require(not unequal, f"texture tables differ between the card and the "
            f"CPU: {unequal}")
    require(rel <= MEAN_RTOL, f"small textured render: card and CPU differ "
            f"by {rel}")
    return dict(rel=rel, tables=len(tables))


def image_formats_cell(handles, tmp, device="cuda"):
    """Phase 23's checks after phase 22: 23a and 23b's large fixtures
    (both started beside 21a: textured_cli_start's handles), 23b, 23c."""
    facts = textured_cli_check(handles[0], device)
    facts["large_s"] = large_fixtures_check(handles[1])
    facts["decode_s"] = fixture_decodes((device, "cpu") if device == "cuda"
                                        else ("cpu",))
    facts["small"] = textured_small(tmp, device)
    return facts


def warm_up(scene, label, render=None, max_timed=2):
    """One warm-up wave of render (path.render unless given). Returns
    (progress callback, the lists it fills with each wave's seconds and
    rays, the number of waves to time: max_timed, or one if the warm-up
    took over 60 s). The caller resets the counters it reads, then
    renders the timed waves with the callback."""
    import torch
    from hairpt_torch.integrators import path

    times, rays = [], []

    def progress(done, total, secs, n_rays):
        torch.cuda.synchronize()
        times.append(secs)
        rays.append(n_rays)

    (render or path.render)(scene, spp=1, seed=0, progress=progress)
    warm = times[0]
    n_timed = max_timed if warm <= 60.0 else 1
    log(f"{label}: warm-up wave {warm:.2f}s, {rays[0]:.0f} rays"
        + ("" if n_timed == max_timed or max_timed == 1
           else "; over 60 s, so ONE timed wave"))
    times.clear()
    rays.clear()
    return progress, times, rays, n_timed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import hairpt_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the hairpt_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import _native, bvh
    from hairpt_torch.ops import instancing as gi
    from hairpt_torch.ops import intersect as isec
    from hairpt_torch.ops import intersect_blocked as iblk
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import irrcache_interp as ic
    from hairpt_torch.ops import photon_query as pq
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.models import media

    plains = []

    def reset_all():
        ic.reset_counts()
        media.reset_counts()
        pq.reset_counts()
        tk.reset_counts()
        pk.reset_counts()
        ipk.reset_counts()
        gi.reset_counts()
        isec.reset_counts()
        iblk.reset_counts()

    try:
        # ---- 0. the card ----
        t0 = time.time()
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError) as e:
            smi = f"nvidia-smi failed: {e}"
        print(smi, flush=True)
        kind = torch.cuda.get_device_name(0)
        log(f"phase 0 ({time.time() - t0:.1f}s): {kind}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}")

        # ---- 1. builds, all at once ----
        t0 = time.time()
        with ThreadPoolExecutor(12) as ex:
            futs = [ex.submit(f) for f in (tk.lib, tk.oct_lib, pk.lib,
                                           pk.cull_lib, ipk.lib, gi.lib,
                                           isec.lib, iblk.lib, media.lib,
                                           pq.lib, ic.lib)]
            f_b = ex.submit(bvh._load_native)
            for f in futs:
                f.result()
            require(f_b.result() is not None, "the BVH builder did not build")
        for name, s in _native.BUILD_SECONDS.items():
            log(f"built {name} in {s:.1f}s")
        for name in ("hairpt_tiled", "hairpt_octets", "hairpt_phaseb",
                     "hairpt_swept_cull", "hairpt_packed",
                     "hairpt_instanced", "hairpt_perray", "hairpt_blocked",
                     "hairpt_woodcock", "hairpt_photons",
                     "hairpt_irrcache"):
            for line in _native.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        log(f"phase 1 ({time.time() - t0:.1f}s): builds done")

        # ---- 2. kernels against plain versions, octet/stream modes ----
        # the plain phase B versions (B, C, D) take a whole wave's tiles
        # in one chunk: tiles are independent, so the per-tile arithmetic
        # is the same, and the host walks each slot loop once per wave
        # instead of once per 1,024 tiles (a few GiB of temporaries)
        tk.PLAIN_B_TILES = PLAIN_TILES_ON_CARD
        t0 = time.time()
        scene = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                            device="cuda")
        sw = scene.arrays.hair_swept
        C, _, K = sw.seg_rows_t.shape
        log(f"scene: {scene.arrays.hair.p0.shape[0]} segments, C={C}, "
            f"K={K}, seg_rows_t {sw.seg_rows_t.numel() * 4 / 1e6:.1f} MB, "
            f"built in {time.time() - t0:.1f}s")
        t1 = time.time()
        wv, wv_sw, hit_frac = waves(scene)
        log(f"waves: camera hit fraction {hit_frac:.4f}")
        report = {}
        errs = check_kernels(scene, wv, report)
        plain_b = check_phase_b(scene, report, errs)
        times = phase_b_times(scene, report, plain_b)
        kernels = time_kernels(scene, report, errs, times)
        del report
        log(f"phase 2a ({time.time() - t1:.1f}s): kernels A-D match their "
            f"plain versions")
        t1 = time.time()
        oct_launches = check_modes(scene, wv)
        log(f"phase 2b ({time.time() - t1:.1f}s): octet and stream modes "
            f"give the dense answer; launches {oct_launches}")
        t1 = time.time()
        kernels += check_swept_kernels(scene, wv_sw)
        t2 = time.time()
        f_report = {}
        plain_2 = PlainWalks()
        plains.append(plain_2)
        finish_12b = furball_kernel_f(scene, wv, f_report, plain_2)
        log(f"phase 12b ({time.time() - t2:.1f}s): kernel F's hair leaf "
            f"agrees with the tiled query; its plain walks queued")
        t2 = time.time()
        hi_report = {}
        finish_14a = furball_walks(scene, wv, hi_report, plain_2)
        log(f"phase 14a, furball ({time.time() - t2:.1f}s): kernels H and I "
            f"timed; their plain walks queued")
        t2 = time.time()
        sub_a = tiled_options(scene, wv)
        log(f"phase 15a ({time.time() - t2:.1f}s): kernel A over the "
            f"sub-cluster boxes matches its plain version; subcull, short_t "
            f"and two_round agree with the default query")
        del wv, wv_sw
        # 12b's and 14a's plain walks run beside phases 2d-3c, which time
        # nothing; they finish before phase 4's timed waves
        plain_2.start()
        t_plain = time.time()
        log(f"phase 2 ({time.time() - t0:.1f}s): the swept phase A and "
            f"kernel E match their plain versions ({time.time() - t1:.1f}s)")
        t0 = time.time()
        hair_errs = {"cull_phase_a": 0.0, "phase_b": 0.0}
        for name in ("straight", "curl"):
            check_hair_kernels(name, hair_errs)
        log(f"phase 2d ({time.time() - t0:.1f}s): kernels A and B match "
            f"their plain versions on the straight-hair and hair-curl "
            f"waves (largest |te diff| {hair_errs['cull_phase_a']:.3g}, "
            f"|t diff| {hair_errs['phase_b']:.3g})")

        # ---- 3. small renders, card against CPU ----
        t0 = time.time()
        small_reference(reset_all)
        log(f"phase 3 ({time.time() - t0:.1f}s): small renders agree")
        t0 = time.time()
        small_gradients(reset_all)
        log(f"phase 3b ({time.time() - t0:.1f}s): small gradients agree")
        t0 = time.time()
        small_hair_renders(reset_all)
        log(f"phase 3c ({time.time() - t0:.1f}s): the hair BSDFs agree")

        # ---- 12b, 14a: the plain walks queued in phase 2 ----
        t0 = time.time()
        finish_12b()
        log(f"phase 12b: kernel F's hair leaf matches its plain walk")
        finish_14a()
        plain_2.close()
        log(f"phase 12b/14a plain walks ({time.time() - t_plain:.1f}s in "
            f"their subprocess beside phases 2d-3c, {time.time() - t0:.1f}s "
            f"waited here): kernels H and I match their plain versions, H "
            f"matches F, I matches H")

        # ---- 4. the full-width render, tiled ----
        t0 = time.time()
        progress, times, rays, n_timed = warm_up(scene, "tiled")
        reset_all()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        off_path = dict(tk.OCT_LAUNCHES, **tk.SUB_LAUNCHES, **pk.LAUNCHES)
        plain_cuda = dict(tk.PLAIN_ON_CUDA)
        mean_tiled = float(img.mean())
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        log(f"tiled render: {n_timed} timed waves of 1 spp at 1024^2, depth "
            f"65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s")
        log(f"image mean {mean_tiled:.6f}, shape {tuple(img.shape)}; max "
            f"completion passes {itiled.STATS['max_passes']}, queries "
            f"{itiled.STATS['queries']}, overflow tiles "
            f"{itiled.STATS['overflow_tiles']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {launches}; kernels off this "
            f"path: {off_path}; plain-version calls on CUDA tensors: "
            f"{plain_cuda}")
        require(np.isfinite(mean_tiled) and mean_tiled > 0,
                f"image mean {mean_tiled}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
        require(all(v > 0 for v in launches.values()),
                f"a kernel was not launched on the main path: {launches}")
        require(all(v == 0 for v in off_path.values()),
                f"the tiled render ran an octet or swept kernel: {off_path}")
        require(all(v == 0 for v in plain_cuda.values()),
                f"plain versions ran on CUDA tensors: {plain_cuda}")
        log(f"phase 4 ({time.time() - t0:.1f}s): render ok")
        del img

        # ---- 15b. the full-width furball, tiled_sub and tiled_short ----
        t0 = time.time()
        opt_r = option_renders(scene, reset_all)
        log(f"phase 15b ({time.time() - t0:.1f}s): the tiled_sub and "
            f"tiled_short renders ok (phase 4's tiled: {secs:.3f} s/wave)")

        # ---- 22c. make_li_fn's ablate knobs on phase 4's scene ----
        t0 = time.time()
        ablated = ablate_waves(scene, reset_all, secs)
        log(f"phase 22c ({time.time() - t0:.1f}s): {ABLATE_ROUNDS} timed "
            f"rounds of a wave under each ablate knob ok")

        # ---- 5. the full-width render, swept ----
        t0 = time.time()
        scene_sw = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                               device="cuda", traversal="swept")
        log(f"swept scene built in {time.time() - t0:.1f}s (p_max "
            f"{scene_sw.config.swept_pmax}, chunk "
            f"{scene_sw.config.swept_chunk})")
        progress, times, rays, n_sw = warm_up(scene_sw, "swept")
        reset_all()
        iswept.STATS.update(queries=0, rays=0, overflow_rays=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene_sw, spp=n_sw, seed=1, progress=progress)
        torch.cuda.synchronize()
        sw_launches = dict(pk.LAUNCHES)
        sw_off = dict(tk.LAUNCHES, **tk.OCT_LAUNCHES)
        sw_plain = dict(pk.PLAIN_ON_CUDA, **tk.PLAIN_ON_CUDA)
        mean_sw = float(img.mean())
        secs_sw = sum(times) / len(times)
        rays_sw = sum(rays) / len(rays)
        st = iswept.STATS
        log(f"swept render: {n_sw} timed waves of 1 spp at 1024^2, depth "
            f"65: {rays_sw:.0f} rays/wave, {secs_sw:.3f} s/wave, "
            f"{rays_sw / secs_sw / 1e6:.4f} Mrays/s")
        log(f"image mean {mean_sw:.6f} (ratio to the tiled render's "
            f"{mean_sw / mean_tiled:.6f}); {st['queries']} queries, "
            f"{st['overflow_rays']} of {st['rays']} live rays "
            f"({st['overflow_rays'] / max(1, st['rays']):.6f}) entered more "
            f"than p_max boxes; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {sw_launches}; tiled kernels: "
            f"{sw_off}; plain-version calls on CUDA tensors: {sw_plain}")
        require(np.isfinite(mean_sw) and mean_sw > 0,
                f"swept image mean {mean_sw}")
        require(bool(torch.isfinite(img).all()), "non-finite swept pixels")
        require(all(v > 0 for v in sw_launches.values()),
                f"a swept kernel was not launched by the swept render: "
                f"{sw_launches}")
        require(all(v == 0 for v in sw_off.values()),
                f"the swept render ran a tiled kernel: {sw_off}")
        require(all(v == 0 for v in sw_plain.values()),
                f"plain versions ran on CUDA tensors: {sw_plain}")
        log(f"phase 5 ({time.time() - t0:.1f}s): swept render ok")
        del scene_sw, img

        # ---- 14d. the full-width furball, perray and blocked ----
        t0 = time.time()
        fur_walk = walk_waves(scene, "the furball", reset_all, warm=False)
        log(f"phase 14d, furball ({time.time() - t0:.1f}s): perray and "
            f"blocked waves ok (phase 4's tiled: {secs:.3f} s/wave)")

        # ---- 6. bench.py's backward phase: fwd+bwd at depth 16 ----
        t0 = time.time()
        bwd = bench_backward(scene, reset_all)
        log(f"phase 6 ({time.time() - t0:.1f}s): fwd+bwd step ok")

        # ---- 7. path-replay backprop at depth 65 ----
        t0 = time.time()
        prb = prb_step(scene, reset_all, bwd)
        log(f"phase 7 ({time.time() - t0:.1f}s): PRB step ok")

        # ---- 16a/16b. rendering and the inverse step across GPUs; 10. the
        # inverse-rendering twin, beside 16b's gloo ranks ----
        t0 = time.time()

        def phase_10():
            t2 = time.time()
            inverse_twin()
            log(f"phase 10 ({time.time() - t2:.1f}s, beside 16b's gloo "
                f"ranks): inverse twin ok")
        shard = sharded_cells(scene, reset_all, between=phase_10)
        log(f"phase 16a/16b ({time.time() - t0:.1f}s, 10 included): the "
            f"sharded render and train step agree with one process (NCCL, "
            f"world 1: {shard['wave_s']:.3f} s/wave, film all_reduce "
            f"{shard['allreduce_ms']:.4f} ms) and two gloo ranks agree with "
            f"world size 1")

        # ---- 8. the full-width Marschner furball ----
        t0 = time.time()
        del scene
        scene_m = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                              device="cuda", material="marschner")
        log(f"Marschner furball built in {time.time() - t0:.1f}s")
        progress, times, rays, n_m = warm_up(scene_m, "marschner")
        reset_all()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene_m, spp=n_m, seed=1, progress=progress)
        torch.cuda.synchronize()
        m_launches = dict(tk.LAUNCHES)
        m_off = dict(tk.OCT_LAUNCHES, **pk.LAUNCHES)
        m_plain = dict(tk.PLAIN_ON_CUDA)
        mean_m = float(img.mean())
        secs_m = sum(times) / len(times)
        rays_m = sum(rays) / len(rays)
        log(f"Marschner render: {n_m} timed waves of 1 spp at 1024^2, depth "
            f"65: {rays_m:.0f} rays/wave, {secs_m:.3f} s/wave, "
            f"{rays_m / secs_m / 1e6:.4f} Mrays/s (phase 4's rough plastic: "
            f"{rays_w / secs / 1e6:.4f}); image mean {mean_m:.6f}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {m_launches}; kernels off "
            f"this path: {m_off}; plain-version calls on CUDA tensors: "
            f"{m_plain}")
        require(np.isfinite(mean_m) and mean_m > 0,
                f"Marschner image mean {mean_m}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
        require(all(v > 0 for v in m_launches.values()),
                f"a kernel was not launched by the Marschner render: "
                f"{m_launches}")
        require(all(v == 0 for v in m_off.values()),
                f"the Marschner render ran an octet or swept kernel: "
                f"{m_off}")
        require(all(v == 0 for v in m_plain.values()),
                f"plain versions ran on CUDA tensors: {m_plain}")
        log(f"phase 8 ({time.time() - t0:.1f}s): Marschner render ok")
        del img

        # ---- 9. bench.py's backward phase on the Marschner furball ----
        t0 = time.time()
        hbwd = hair_backward(scene_m, reset_all)
        del scene_m
        log(f"phase 9 ({time.time() - t0:.1f}s): Marschner fwd+bwd step ok")

        # ---- 11. the scene-XML entry point ----
        t0 = time.time()
        xml_launches = xml_entry_point(reset_all, rays_w / secs / 1e6)
        log(f"phase 11 ({time.time() - t0:.1f}s): the XML entry point ok")

        per_wave = {k: (v, n_timed) for k, v in launches.items()}
        per_wave.update({k: (v, None) for k, v in oct_launches.items()})
        per_wave.update({k: (v, n_sw) for k, v in sw_launches.items()})
        for k in kernels:
            n, waves_n = per_wave[k["name"]]
            k["launches"] = n
            k["launches_per_wave"] = n / waves_n if waves_n else None
            k["launched_by"] = ("the octet and stream queries of phase 2b"
                                if waves_n is None else
                                "the timed waves of phase 5"
                                if k["name"] in sw_launches else
                                "the timed waves of phase 4")
        for k in kernels:
            if k["name"] in bwd["launches"]:
                k["launches_per_fwd_bwd_step"] = bwd["launches"][k["name"]]
                k["launches_per_prb_step"] = prb["launches"][k["name"]]
                k["launches_per_marschner_wave"] = \
                    m_launches[k["name"]] / n_m
                k["launches_per_marschner_fwd_bwd_step"] = \
                    hbwd["launches"][k["name"]]
            if k["name"] in xml_launches:
                k["launches_per_xml_wave"] = xml_launches[k["name"]]

        # ---- 12. triangle meshes and the teapot through kernel F ----
        t0 = time.time()
        teapot_kernels(f_report)
        log(f"phase 12a ({time.time() - t0:.1f}s): kernel F's triangle leaf "
            f"matches its plain walk on the teapot's and the heightfield's "
            f"waves")
        t1 = time.time()
        floor = {}

        def phase_12d():
            t2 = time.time()
            floor["launches"] = furball_floor(reset_all)
            log(f"phase 12d ({time.time() - t2:.1f}s, beside 12c's CLI): "
                f"the furball over the checkerboard agrees card against CPU")
        tea_secs, tea_rays, tea_launches, tea_n = teapot_entry_point(
            reset_all, between=phase_12d)
        floor_launches = floor["launches"]
        log(f"phase 12c ({time.time() - t1:.1f}s, 12d included): the teapot "
            f"CLI and render ok")
        kernels += f_kernel_entries(f_report, tea_launches, floor_launches,
                                    tea_n)
        log(f"phase 12 ({time.time() - t0:.1f}s, 12b in phase 2): ok")

        # ---- 13. instanced meshes through kernel G ----
        t0 = time.time()
        g_report = {}
        plain_13 = PlainWalks()
        plains.append(plain_13)
        finish_13a = instanced_kernels(g_report, plain_13)
        plain_13.start()
        log(f"phase 13a ({time.time() - t0:.1f}s): kernel G and its "
            f"yardsticks timed; its plain walks started beside 13b and 13c's "
            f"CLI")
        t1 = time.time()

        def phase_13b():
            t2 = time.time()
            instanced_small(reset_all)
            log(f"phase 13b ({time.time() - t2:.1f}s, beside 13c's CLI): the "
                f"small instanced render agrees card against CPU")
            t2 = time.time()
            finish_13a()
            plain_13.close()
            log(f"phase 13a's plain walks ({time.time() - t1:.1f}s after "
                f"they started, {time.time() - t2:.1f}s waited here): kernel "
                f"G matches its plain version on the instanced stand-in's "
                f"waves")
        inst_secs, inst_rays, g_launches, _, inst_n = instanced_entry_point(
            reset_all, between=phase_13b)
        log(f"phase 13c ({time.time() - t1:.1f}s, 13b included): the "
            f"instanced render and CLI ok")
        kernels += g_kernel_entries(g_report, g_launches, inst_n)
        log(f"phase 13 ({time.time() - t0:.1f}s): ok")

        # ---- 14. motion blur; the perray and blocked walks (H, I) ----
        t0 = time.time()
        tea = teapot_walks(hi_report)
        log(f"phase 14a, teapot ({time.time() - t0:.1f}s): kernels H and I "
            f"match their plain versions, H matches F, I matches H")
        t1 = time.time()
        tea_walk = walk_waves(tea, "the teapot", reset_all)
        del tea
        walk_floor(reset_all)
        log(f"phase 14d, teapot and floor ({time.time() - t1:.1f}s): ok")
        t1 = time.time()
        motion = motion_entry_point(
            reset_all, also=lambda s: motion_full(s, reset_all))
        log(f"phase 14b/c ({time.time() - t1:.1f}s, 20d's full-width wave "
            f"included): the motion cell, the small card-against-CPU render "
            f"and the CLI ok ({motion['secs']:.3f} s/wave)")
        walks = {(trav, leaf): (w[trav][2], w[trav][3])
                 for leaf, w in (("hair", fur_walk), ("tri", tea_walk))
                 for trav in ("perray", "blocked")}
        kernels += hi_kernel_entries(hi_report, walks)
        log(f"phase 14 ({time.time() - t0:.1f}s, 14a's furball in phase 2, "
            f"14d's in phase 5): ok")

        # ---- 15c. area and delta lights: the lit stand-in ----
        t0 = time.time()
        lit = lit_cell(reset_all)
        log(f"phase 15c ({time.time() - t0:.1f}s): the lit cell, its CLI, "
            f"the small card-against-CPU render and gradient and PRB ok "
            f"({lit['secs']:.3f} s/wave)")
        kernels.append(sub_kernel_entry(
            sub_a, opt_r["tiled_sub"]["launches"]["cull_phase_a_sub"]))
        for k in kernels:
            if k["name"] in lit["launches"]:
                k["launches_per_lit_wave"] = \
                    lit["launches"][k["name"]] / lit["n_timed"]
        log(f"phase 15 (15a in phase 2, 15b after phase 4): ok")

        # ---- 16c/16d. the materials cell and the other sensors ----
        t0 = time.time()
        mats = materials_cell(reset_all,
                              also=lambda s: mlt_full(s, reset_all))
        log(f"phase 16c ({time.time() - t0:.1f}s, 20a's MLT included): the "
            f"materials cell, its CLI, the small card-against-CPU render and "
            f"gradient and PRB ok ({mats['secs']:.3f} s/wave)")
        for k in kernels:
            if k["name"] in mats["launches"]:
                k["launches_per_materials_wave"] = \
                    mats["launches"][k["name"]] / mats["n_timed"]
        t0 = time.time()
        sens = sensor_kinds()
        log(f"phase 16d ({time.time() - t0:.1f}s): every other sensor kind "
            f"agrees card against CPU: {sens}")
        log(f"phase 16 (16a/16b after phase 7): ok")

        # ---- 17. participating media and subsurface scattering ----
        t0 = time.time()
        med_facts, j_report = media_cell(reset_all)
        log(f"phase 17a/b ({time.time() - t0:.1f}s): kernel J, the media "
            f"cell, its CLI and the small card-against-CPU render ok "
            f"({med_facts['secs']:.3f} s/wave)")
        kernels += j_kernel_entries(j_report, med_facts["launches"],
                                    med_facts["n_timed"])
        for k in kernels:
            if k["name"] in med_facts["launches"]:
                k["launches_per_media_wave"] = \
                    med_facts["launches"][k["name"]] / med_facts["n_timed"]
        t1 = time.time()
        bnd = bounded_cell(reset_all)
        log(f"phase 17c ({time.time() - t1:.1f}s): the bounded-media cell "
            f"and its small card-against-CPU render ok "
            f"({bnd['secs']:.3f} s/wave)")
        t1 = time.time()
        pre = subsurface_cell(reset_all)
        log(f"phase 17d ({time.time() - t1:.1f}s): the dipole prepass "
            f"({pre:.3f} s) and the dipole and single-scatter renders card "
            f"against CPU ok")
        log(f"phase 17 ({time.time() - t0:.1f}s): ok")

        # ---- 18. the light tracers and the photon maps (kernel K) ----
        t0 = time.time()
        light, k_report = light_cells(reset_all)
        kernels += k_kernel_entries(k_report, light)
        for k in kernels:
            for run in LIGHT_TRACERS + ("fog",):
                if k["name"] in light[run]["launches"]:
                    k[f"launches_per_{run}_wave"] = \
                        light[run]["launches"][k["name"]] \
                        / light[run]["waves"]
        log(f"phase 18 ({time.time() - t0:.1f}s): ok; s per wave or pass "
            + ", ".join(f"{r} {light[r]['secs']:.3f}"
                        for r in LIGHT_TRACERS + ("fog",)))

        # ---- 19. the other integrators (kernel L) ----
        t0 = time.time()
        integ, l_report = integrator_cells(reset_all)
        kernels += l_kernel_entries(l_report, integ)
        per = {"irrcache": ("wave", 1), "irrcache_nograd": ("wave", 1),
               "pssmlt": ("step", MC_MUTATIONS + 1),
               "erpt": ("step", MC_MUTATIONS + 1),
               "spectral": ("band", SPECTRAL_BINS // 3)}
        per.update({r: ("wave", len(integ[r]["steps"])) for r in AUX_RUNS})
        for k in kernels:
            for run, (unit, n) in per.items():
                if k["name"] in integ[run]["launches"]:
                    k[f"launches_per_{run}_{unit}"] = \
                        integ[run]["launches"][k["name"]] / n
        log(f"phase 19 ({time.time() - t0:.1f}s): ok; s per wave, step or "
            f"band " + ", ".join(f"{r} {integ[r]['secs']:.3f}"
                                 for r in per))

        # ---- 20. path-space MLT, the manifold walk, motion vectors ----
        t0 = time.time()
        mlt_f, mv_f = mats["also"], motion["also"]
        mlt_motion_cells()
        rounds = mlt_f["rounds"]
        for k in kernels:
            if k["name"] in rounds[0]:
                k["launches_per_mlt_round"] = \
                    sum(r[k["name"]] for r in rounds) / len(rounds)
            if k["name"] in mv_f["launches"]:
                k["launches_per_motion_vector_wave"] = \
                    mv_f["launches"][k["name"]]
        log(f"phase 20 ({time.time() - t0:.1f}s after phase 19; 20a in 16c, "
            f"20d's full-width wave in 14b): ok; mlt pool "
            f"{mlt_f['pool_s']:.3f} s, s per round "
            f"{[round(x, 3) for x in mlt_f['round_s']]}; motion vectors "
            f"{mv_f['secs']:.3f} s per wave")

        # ---- 21. the irawan cloth cell; the CLI's banded render, --stats,
        # --profile, util and import; 22a's CLI started beside 21a ----
        t0 = time.time()
        import tempfile
        tmp22 = tempfile.mkdtemp(prefix="hairpt_codecs_")
        tmp23 = tempfile.mkdtemp(prefix="hairpt_formats_")
        h22 = annotated_cli_start(tmp22)
        h23 = textured_cli_start(tmp23)
        # 23a's CLI and 23b's large-fixture decode
        procs23 = (h23[0][0], h23[1][0])
        try:
            cl = cloth_cells(reset_all)
        except BaseException:
            _stop(h22[0], *procs23)
            raise
        for k in kernels:
            if k["name"] in cl["launches"]:
                k["launches_per_cloth_wave"] = \
                    cl["launches"][k["name"]] / cl["n_timed"]
        log(f"phase 21 ({time.time() - t0:.1f}s): ok; the cloth cell "
            f"{cl['secs']:.3f} s per wave, {cl['queries']:.1f} tiled queries "
            f"per wave, {cl['share']:.4f} of the camera lanes on cloth")

        # ---- 22. the annotated JPEG CLI (started beside 21a), the codec on
        # the card and the CPU, the leftovers (22c after phase 15b) ----
        t0 = time.time()
        try:
            annot, frame = annotated_cli_check(h22)
            codec = codec_sides(frame, tmp22)
            leftovers_cell()
        except BaseException:
            _stop(*procs23)
            raise
        finally:
            import shutil
            shutil.rmtree(tmp22, ignore_errors=True)
        for k in kernels:
            if k["name"] in annot["launches"]:
                k["launches_in_the_annotated_cli"] = \
                    annot["launches"][k["name"]]
            if k["name"] in ablated["none"]["launches"]:
                k["launches_per_ablated_wave"] = {
                    n: a["launches"][k["name"]] for n, a in ablated.items()}
        enc, dec = ({d: codec[d][k] for d in ("cuda", "cpu")}
                    for k in ("encode", "decode"))
        log(f"phase 22 ({time.time() - t0:.1f}s after phase 21; 22a's CLI "
            f"beside 21a, 22c after 15b): ok; the CLI's JPEG PSNR "
            f"{annot['psnr']:.2f} dB; write_jpg card {enc['cuda']:.3f} s, "
            f"CPU {enc['cpu']:.3f} s; read_image card {dec['cuda']:.3f} s, "
            f"CPU {dec['cpu']:.3f} s; ablated median s/wave "
            + ", ".join(f"{n} {a['secs']:.3f} ({a['ratio']:.3f}x)"
                        for n, a in ablated.items()))

        # ---- 23. the image formats through PIL's readers and writers:
        # 23a's textured CLI (started beside 21a), the fixtures, the small
        # card-against-CPU render ----
        t0 = time.time()
        try:
            fmt = image_formats_cell(h23, tmp23)
        finally:
            _stop(*procs23)
            import shutil
            shutil.rmtree(tmp23, ignore_errors=True)
        for k in kernels:
            if k["name"] in fmt["launches"]:
                k["launches_in_the_textured_cli"] = \
                    fmt["launches"][k["name"]]
        log(f"phase 23 ({time.time() - t0:.1f}s after phase 22; 23a's CLI "
            f"beside 21a): ok; the textured CLI built in {fmt['build']}s "
            f"(its {ENV23A} decoded in {fmt['decoded'][ENV23A][2]:.3f}s), "
            f"rendered in {fmt['render']}s; fixtures decoded in "
            f"{sum(fmt['decode_s'].values()):.3f}s, the large ones in "
            f"{sum(v['s'] for v in fmt['large_s'].values()):.3f}s beside "
            f"23a; small card against CPU {fmt['small']['rel']:.3g}")
        require(all(k["launches"] > 0 for k in kernels),
                "a kernel has no launches")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        for pw in plains:
            pw.close()
    log(f"total {time.time() - T_START:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--cpu-refs"]:
        sys.exit(cpu_refs(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--plain-walks"]:
        sys.exit(plain_walks_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--large-fixtures"]:
        sys.exit(large_fixtures_worker(*sys.argv[2:4]))
    sys.exit(main())
