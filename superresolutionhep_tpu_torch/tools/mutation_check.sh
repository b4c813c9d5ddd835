#!/bin/bash
# Mutation check of the CUDA kernels: each deliberately broken kernel source
# must make chip_smoke.py fail (a kernel that disagrees with its plain PyTorch
# version, or does not build, never falls back to the plain version).
#
# Run from the repository root on a machine with the card and nvcc:
#     bash superresolutionhep_tpu_torch/tools/mutation_check.sh [name ...]
# (with names, only those mutations run).  The broken copies are made in a
# fresh temporary directory, never in the repository.  Prints one
# "MUTATION <name> exit=<code> ..." line per mutation; every exit code must be
# non-zero, every ok_line count 0 and every unseen count 0 (the run --skip-serve
# --skip-train always ends non-zero: a mutation is seen only if the run stopped
# before that, at the ptxas gate or at a check).  With CASES set to names of
# chip_smoke.py's case functions (e.g. CASES="fp32_tile_cases kernel_cases"),
# only those run, past the build's ptxas gate: whether a check of the kernels'
# results sees a mutation whose build the gate already refuses
# (CASES=parallel_phase runs the parallel phase alone, CASES=parallel_pf_phase
# the stage-2 parallel and split-validation phase).
ROOT=$(pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
status=0
SELECTED="$*"
run() {  # name, sed expression, file
  if [ -n "$SELECTED" ] && [[ " $SELECTED " != *" $1 "* ]]; then return; fi
  rm -rf "$WORK/mut" && mkdir -p "$WORK/mut" && cp -r "$ROOT/chip_smoke.py" "$ROOT/superresolutionhep_tpu_torch" "$WORK/mut/" && cd "$WORK/mut" || exit 9
  before=$(md5sum "$3" | cut -d' ' -f1)
  sed -i "$2" "$3"
  after=$(md5sum "$3" | cut -d' ' -f1)
  if [ "$before" = "$after" ]; then echo "MUTATION $1 did not change $3"; exit 9; fi
  if [ -n "$CASES" ]; then
    # a file, not stdin: the parallel phase's spawned ranks re-import the main module
    printf '%s\n' 'import inspect, sys' 'import chip_smoke as cs' 'if __name__ == "__main__":' \
      '    for name in sys.argv[1:]:' '        fn = getattr(cs, name)' \
      '        fn(2) if inspect.signature(fn).parameters else fn()' > cases.py
    SRHEP_TORCH_BUILD_DIR="$WORK/mut/build" python3 cases.py $CASES > out.txt 2> err.txt
  else
    SRHEP_TORCH_BUILD_DIR="$WORK/mut/build" python3 chip_smoke.py --skip-serve --skip-train --reps 2 > out.txt 2> err.txt
  fi
  rc=$?
  oks=$(grep -c '^{"ok": true' out.txt)
  unseen=$(grep -c 'a main path was not driven' err.txt)
  echo "MUTATION $1 exit=$rc ok_line=$oks unseen=$unseen failing_cases=$(grep -c '"ok": false' out.txt)"
  tail -n 2 err.txt | cut -c 1-600
  if [ "$rc" = "0" ] || [ "$oks" != "0" ] || [ "$unseen" != "0" ]; then status=1; fi
  cd "$ROOT" || exit 9
}
run nomax_drops_key_mask 's/id\.\([xy]\) == qid\([01]\) ? kClipHi : kMaskedLogit/kClipHi/' superresolutionhep_tpu_torch/csrc/flash_attention.cu
run lrelu_slope 's/kLreluSlope = 0.01f/kLreluSlope = 0.02f/' superresolutionhep_tpu_torch/csrc/common.cuh
run qkv_forgets_bias 's/pack_bf16(acc\[4 \* j\] + bb\[j\].x, acc\[4 \* j + 1\] + bb\[j\].y)/pack_bf16(acc[4 * j], acc[4 * j + 1])/' superresolutionhep_tpu_torch/csrc/fused_qkv.cu
run syntax_error 's/float acc\[32\];/float acc[32]/' superresolutionhep_tpu_torch/csrc/common.cuh
run bwd_dq_sign_of_dl 's/\* (dp\[4 \* j\] - dl0);/* (dp[4 * j] + dl0);/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dkv_drops_key_bias 's/    if (kid0 < 0) dka\[i\] = dka\[i + 1\] = dva\[i\] = dva\[i + 1\] = 0.f;//' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dkv_ignores_segments 's/s\[4 \* j\] = id\.x == kid0 ? s\[4 \* j\] : kNegInf;/s[4 * j] = s[4 * j];/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dkv_ring_reads_wrong_stage 's/kmajor_descs<D>(db, qs0 + ns \* T::kTileBytes);/kmajor_descs<D>(db, qs0 + (ns + 1) % NS * T::kTileBytes);/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dq_band_drops_last_tile 's/kt_last = bd.x + bd.y - 1;/kt_last = bd.x + bd.y - 2;/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dkv_band_drops_last_tile 's/qt_last = bd.x + bd.y - 1;/qt_last = bd.x + bd.y - 2;/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run bwd_dv_takes_ds 's/issue_pb<D>(dva, pp, gm)/issue_pb<D>(dva, pd, gm)/g' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run packed_fwd_ignores_segments 's/= id\.\([xy]\) == qid\([01]\) ? s\[/= id.\1 >= 0 ? s[/' superresolutionhep_tpu_torch/csrc/flash_attention.cu
run fwd_band_drops_last_tile 's/kt_last = bd.x + bd.y - 1;/kt_last = bd.x + bd.y - 2;/' superresolutionhep_tpu_torch/csrc/flash_fwd.cuh
run fwd_ring_reads_wrong_stage 's/make_descs<D, BK>(dq, qs, ks0 + ns \* BK/make_descs<D, BK>(dq, qs, ks0 + (ns + 1) % NS * BK/' superresolutionhep_tpu_torch/csrc/flash_fwd.cuh
run packed_dkv_drops_ln2 's/    dk = (dk.float() \* LN2).to(k.dtype)/    dk = dk.to(k.dtype)/' superresolutionhep_tpu_torch/ops/flash_packed.py
run probe_skips_dead_tile 's/kSeg = false, kSkipDead = false,/kSeg = false, kSkipDead = true,/' superresolutionhep_tpu_torch/csrc/attention_probes.cu
run probe_bf16_exp_in_fp32 's/p\[i\] = ex2_bf16x2(pack_bf16(s\[2 \* i\], s\[2 \* i + 1\]));/p[i] = pack_bf16(ex2(s[2 * i]), ex2(s[2 * i + 1]));/' superresolutionhep_tpu_torch/csrc/attention_probes.cu
run probe_max_spans_64_keys 's/fmaxf(s\[4 \* j\], s\[4 \* j + 1\]));$/fmaxf(s[4 * (j % 8)], s[4 * (j % 8) + 1]));/;s/fmaxf(s\[4 \* j + 2\], s\[4 \* j + 3\]));$/fmaxf(s[4 * (j % 8) + 2], s[4 * (j % 8) + 3]));/' superresolutionhep_tpu_torch/csrc/attention_probes.cu
run probe_drops_key_bias 's/return MASK ? __float_as_int((static_cast<const float\*>(kmask)\[i\] - 1.0f) \* kBig) : 0;/return 0;/' superresolutionhep_tpu_torch/csrc/attention_probes.cu
run segment_rows_pad_to_row0 's/? s : e1 - 1);/? s : 0);/' superresolutionhep_tpu_torch/csrc/common.cuh
run qkv_ring_reads_wrong_stage 's/const uint32_t slab = ring_s + stage \* kFusedSlabBytes;/const uint32_t slab = ring_s + (stage + 1) % kQkvStages * kFusedSlabBytes;/' superresolutionhep_tpu_torch/csrc/fused_qkv.cu
run mlp_ring_reads_wrong_stage 's/    return ring_s + stage \* kFusedSlabBytes;/    return ring_s + (stage + 1) % kMlpStages * kFusedSlabBytes;/' superresolutionhep_tpu_torch/csrc/fused_mlp.cu
run mlp_drops_second_layernorm 's/      warp_layernorm_rows<R>(v, NCH, F);  \/\/ u2 = LN(u)//' superresolutionhep_tpu_torch/csrc/fused_mlp.cu
run fp32_fwd_single_tf32 's/constexpr int kFwdTerms = 3;/constexpr int kFwdTerms = 1;/' superresolutionhep_tpu_torch/csrc/flash_attention.cu
run fp32_dkv_single_tf32 's/constexpr int kDkvTerms = 3;/constexpr int kDkvTerms = 1;/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run fp32_fwd_skips_rescale 's/for (int nt = 0; nt < NT; ++nt) rescale_rows(o\[nt\], al0, al1);/for (int nt = 0; nt < NT; ++nt) continue;/' superresolutionhep_tpu_torch/csrc/flash_attention.cu
run fp32_dkv_sign_of_dl 's/(dpt\[j\]\[\([0-3]\)\] - dlc\.\([xy]\))/(dpt[j][\1] + dlc.\2)/' superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
# the fp32 dq body (flash_bwd_dq_f32_kernel; the sed address keeps each edit inside it)
DQ='/^flash_bwd_dq_f32_kernel(/,/^}/'
BWD=superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu
run fp32_dq_drops_lo_hi "${DQ}s/own_frags(kk, qh, ql, gh, gl);/own_frags(kk, qh, ql, gh, gl); ql[0] = ql[1] = ql[2] = ql[3] = gl[0] = gl[1] = gl[2] = gl[3] = 0u;/" $BWD
run fp32_dq_single_tf32 's/constexpr int kDqTerms = 3;/constexpr int kDqTerms = 1;/' $BWD
run fp32_dq_one_chain "${DQ}s/mma_split<kDqTerms>(t, dh, dlo, bh0, bh1, bl0, bl1);/mma_split<kDqTerms>(dqa[nt], dh, dlo, bh0, bh1, bl0, bl1);/" $BWD
run fp32_dq_k_natural_order "${DQ}s/const int o = (8 \* (j0 + j) + 2 \* tq) \* T::kLd + gq;/const int o = (8 * (j0 + j) + tq) * T::kLd + gq;/;${DQ}s/split_tf32(Ks\[o + T::kLd + 8 \* nt\], bh1, bl1);/split_tf32(Ks[o + 4 * T::kLd + 8 * nt], bh1, bl1);/" $BWD
run fp32_dq_ignores_segments "${DQ}s/(id\.\([xy]\) == qid\([01]\) ? sc\[j\]\[\([0-3]\)\] : kNegInf)/sc[j][\3]/g" $BWD
run fp32_dq_band_drops_last_tile "${DQ}s/      if (nxt < nkt) issue((i + NS - 1) % NS, nxt);/      if (nxt < nkt) issue((i + NS - 1) % NS, nxt); else break;/" $BWD
# the parallel layer (chip_smoke.py's parallel phase): Megatron's f without
# its backward all-reduce, and the gradient all-reduce turned into a mean
# (DistributedDataParallel's), which differs wherever shards hold different
# cell counts
run tp_f_identity 's/        return all_reduce_sum(g, ctx.group), None/        return g, None/' superresolutionhep_tpu_torch/ops/tp.py
run dp_grad_mean 's/    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)/&\n    flat \/= dist.get_world_size(group)/' superresolutionhep_tpu_torch/parallel/comm.py
# the stage-2 parallel layer and the split validation (chip_smoke.py's
# parallel_pf phase; also seen by tests/test_torch_port_parallel_{pf,val}.py):
# a seq shard's loss share not divided by the seq size (every gradient times
# the seq size), the kinematic head's cell sums left local to a seq shard, the
# validation noise drawn per rank instead of for the global batch
run pf_sp_loss_not_divided_by_seq 's/        loss = loss_sum \/ (n_real.clamp_min(1.0) \* n_seq)/        loss = loss_sum \/ n_real.clamp_min(1.0)/' superresolutionhep_tpu_torch/parallel/tp.py
run pf_cell_sum_no_allreduce 's/        return psum(x.sum(-1, keepdim=keepdim), self.sp_group)/        return x.sum(-1, keepdim=keepdim)/' superresolutionhep_tpu_torch/models/pf/kinematics.py
run val_noise_per_rank 's/            x0 = self._val_x0(batch\["e_proxy"\]) if group is not None else None/            x0 = None/' superresolutionhep_tpu_torch/train/sr_trainer.py
exit $status
