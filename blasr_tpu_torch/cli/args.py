"""The blasr flag registry and its mapping to ``MappingParams``.

The port's copy of ``build_arg_parser`` and ``params_from_args`` from
``blasr_tpu/cli/blasr.py`` (:26-375), unchanged, so that a command line
means the same in both packages and ``cli/blasr.py`` can name every flag
the port does not take. Reference: Blasr.cpp:3996-4139 flag registry,
MappingParameters::MakeSane at alignment/MappingParameters.h:367-545.
"""

from __future__ import annotations

import argparse

from blasr_tpu_torch.params import MappingParams


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blasr-tpu",
        description="TPU-native long-read aligner (BLASR-capability framework)",
    )
    p.add_argument("reads", help="reads file (FASTA/FASTQ/SAM)")
    p.add_argument("genome", help="reference genome FASTA")
    # ---- output selection ----
    p.add_argument("-m", type=int, default=4, choices=[0, 1, 2, 3, 4, 5],
                   help="output format (0=stick,1=columns,2=XML,3=vulgar,"
                        "4=interval,5=verbose)")
    p.add_argument("-sam", action="store_true", help="write SAM output")
    p.add_argument("-out", default="-", help="output file (default stdout)")
    p.add_argument("-clipping", default="soft",
                   choices=["none", "soft", "hard", "subread"])
    p.add_argument("-header", action="store_true", help="column header line")
    p.add_argument("-titleTable", default=None, metavar="FILE",
                   help="write contig-title table and print title indices")
    p.add_argument("-unaligned", default=None, metavar="FILE",
                   help="write unaligned read names to FILE")
    p.add_argument("-noPrintUnalignedSeqs", action="store_true",
                   help="names only in -unaligned file (no sequences)")
    # ---- selection / filtering ----
    p.add_argument("-bestn", type=int, default=1)
    p.add_argument("-nCandidates", type=int, default=6)
    p.add_argument("-maxScore", type=int, default=-200)
    p.add_argument("-minPctIdentity", type=float, default=0.0)
    p.add_argument("-minAlnLength", type=int, default=0)
    p.add_argument("-minReadLength", type=int, default=50)
    p.add_argument("-maxReadLength", type=int, default=0,
                   help="skip reads longer than this (0 = no limit)")
    p.add_argument("-placeRepeatsRandomly", action="store_true")
    p.add_argument("-randomSeed", type=int, default=0)
    p.add_argument("-readIndex", type=int, default=None,
                   help="map only the read at this stream index (repro aid, "
                        "Blasr.cpp:4619)")
    p.add_argument("-readIndices", default=None, metavar="I,J,...",
                   help="map only these stream indices")
    # ---- anchoring ----
    p.add_argument("-sa", default=None, metavar="FILE",
                   help="use a reference-format .sa suffix array file")
    p.add_argument("-bwt", nargs="?", const="", default=None, metavar="FILE",
                   help="anchor via the FM-index (low-memory path); optional "
                        "prebuilt .btfm.npz bundle (else built/cached)")
    p.add_argument("-minMatch", type=int, default=14)
    p.add_argument("-maxAnchorsPerPosition", type=int, default=8)
    p.add_argument("-minExpand", type=int, default=0,
                   help="starting anchor expand level (widen SA intervals "
                        "to the (minMatch-e)-base prefix)")
    p.add_argument("-maxExpand", type=int, default=0,
                   help="retry unmapped reads at increasing expand levels")
    p.add_argument("-pvaltype", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("-advanceExactMatches", type=int, default=0,
                   help="(accepted; anchor compaction covers this heuristic)")
    p.add_argument("-anchorStride", type=int, default=1,
                   help="seed every Nth read position (2 = the bench "
                        "operating point; the speed/sensitivity frontier)")
    p.add_argument("-dpCandidates", type=int, default=0,
                   help="candidate windows DP'd per read across strands "
                        "(0 = nCandidates; 2 = the bench operating point)")
    p.add_argument("-maxAnchorsPerRead", type=int, default=512,
                   help="anchors kept per read-strand (the anchor phase is "
                        "gather-bound in this size; 128 = the bench "
                        "operating point)")
    # ---- scoring ----
    p.add_argument("-indel", type=int, default=5)
    p.add_argument("-insertion", type=int, default=None)
    p.add_argument("-deletion", type=int, default=None)
    p.add_argument("-affineOpen", type=int, default=50)
    p.add_argument("-scoreMatrix", default=None, metavar='"25 ints"',
                   help="substitution matrix: 25 space-separated values, "
                        "row-major ACGTN x ACGTN (StringToScoreMatrix.h)")
    p.add_argument("-affineExtend", type=int, default=0)
    p.add_argument("-ignoreQualities", action="store_true",
                   help="disable QV-aware scoring for FASTQ input")
    p.add_argument("-affineAlign", action="store_true",
                   help="(always on: the DP kernel is affine)")
    # ---- input sharding (reference -start/-stride/-subsample) ----
    p.add_argument("-start", type=int, default=0)
    p.add_argument("-stride", type=int, default=1)
    p.add_argument("-subsample", type=float, default=1.0)
    # ---- presets ----
    p.add_argument("-nucmer", action="store_true",
                   help="nucmer emulation preset (SetEmulateNucmer)")
    p.add_argument("-alignContigs", "-piecewise", dest="alignContigs",
                   action="store_true",
                   help="piecewise long-query mapping (multi-Mb contigs)")
    p.add_argument("-useSensitiveSearch", action="store_true",
                   help="sensitivity preset (SetForSensitivity)")
    # ---- TPU shape/batch knobs ----
    p.add_argument("-maxReadLen", type=int, default=3072,
                   help="pad bound; longer reads are truncated (piecewise path for contigs)")
    p.add_argument("-batchSize", type=int, default=64)
    p.add_argument("-noSplitSubreads", action="store_true",
                   help="(accepted; subread splitting applies to region-annotated input)")
    p.add_argument("-nproc", type=int, default=1,
                   help="(accepted; device batching replaces threads)")
    p.add_argument("-ndevices", type=int, default=1,
                   help="chips for the serving path: 1=default device, "
                        "0=all visible, N=first N (batch sharded over a "
                        "dp mesh, index replicated)")
    # ---- observability ----
    p.add_argument("-anchors", default=None, metavar="FILE",
                   help="dump per-read anchors (qpos tpos nhits strand)")
    p.add_argument("-resume", action="store_true",
                   help="resume an interrupted run: append to -out, batch-"
                        "granular checkpoint manifest at <out>.resume.json")
    p.add_argument("-metrics", default=None, metavar="FILE",
                   help="write per-stage timing/counter metrics JSON, the run traced: "
                        "'spans' (per span name: count, seconds, self seconds, most "
                        "device memory at its end) and 'counters' (host waits for the "
                        "device by site, the largest DP arrow tensor, bytes copied each "
                        "way, compiler runs, index builds and cache reads)")
    p.add_argument("-V", "-v", dest="verbosity", type=int, default=0, nargs="?",
                   const=1)
    p.add_argument("-version", action="version", version="blasr-tpu 2.0")
    # ---- long-tail flags with direct semantics ----
    p.add_argument("-match", type=int, default=None,
                   help="match score (<= 0; min-score convention)")
    p.add_argument("-mismatch", type=int, default=None)
    p.add_argument("-sdpTupleSize", type=int, default=11)
    p.add_argument("-forwardOnly", action="store_true",
                   help="map the forward strand only")
    p.add_argument("-minMapQV", type=int, default=0)
    p.add_argument("-maxPctIdentity", type=float, default=100.0)
    p.add_argument("-minAvgQual", type=float, default=0.0)
    p.add_argument("-minAlignLength", dest="minAlnLength2", type=int,
                   default=None, help="alias of -minAlnLength")
    p.add_argument("-minSubreadLength", type=int, default=None,
                   help="alias of -minReadLength (whole reads = subreads "
                        "without region tables)")
    p.add_argument("-maxReadIndex", type=int, default=None,
                   help="map only reads with stream index < this")
    p.add_argument("-printOnlyBest", action="store_true",
                   help="equivalent to -bestn 1")
    p.add_argument("-samqv", nargs="+", default=None, metavar="NAME",
                   help="QV tags to emit in SAM (InsertionQV DeletionQV "
                        "SubstitutionQV MergeQV SubstitutionTag DeletionTag)")
    p.add_argument("-bandSize", "-guidedAlignBandSize", dest="bandSize",
                   type=int, default=0,
                   help="DP band half-width; rounds up to the TPU lane "
                        "quantum (32/64/128)")
    p.add_argument("-useGuidedAlign", "-guidedAlign", dest="useGuidedAlign",
                   action="store_true", default=None,
                   help="per-read anchor-chain band guides (GuidedAlign.h "
                        "role): long buckets keep the base band width")
    p.add_argument("-noUseGuidedAlign", dest="useGuidedAlign",
                   action="store_false",
                   help="disable per-read band guides (length-scaled full "
                        "band on long buckets instead)")
    p.add_argument("-indelRate", type=float, default=0.3)
    p.add_argument("-minInterval", type=int, default=100,
                   help="minimum summed anchor bases for a candidate "
                        "interval (fork default 100, MappingParameters.h:348)")
    p.add_argument("-removeContained", action="store_true",
                   help="(always on: read-span containment gates -bestn)")
    # ---- accepted-for-compatibility flags (semantics subsumed by the
    # TPU design; see PARITY.md; each lists its coverage) ----
    _compat_int = [
        ("maxLCPLength", "anchor length cap: fixed-k seeding bounds this"),
        ("maxExtendDropoff", "window pad + local clamp subsume extension"),
        ("extendBandSize", "same"),
        ("maxAnchorGap", "diagonal-window clustering bounds gaps"),
        ("maxGap", "same"),
        ("branchExpand", "-minExpand/-maxExpand are the expand cascade"),
        ("nbranch", "same"),
        ("contextAlignLength", "not used outside HDF context"),
        ("recurseOver", "SDP recursion threshold (pipeline/sdp.py fixed)"),
        ("sdpIns", "SDP path uses the global -indel costs"),
        ("sdpDel", "same"),
        ("sdpindel", "same"),
        ("sdpMaxAnchorsPerPosition", "SDP seeding caps internally"),
        ("globalChainType", "one chaining algorithm by design"),
        ("sdpFilterType", "same"),
        ("maxRefine", "single-pass full-band refinement"),
        ("stopMappingOnceUnique", "anchor compaction covers the heuristic"),
        ("advanceHalf", "same"),
        ("saLookupTableLength", "direct 4^k table is built automatically"),
        ("maxMatch", "fixed-k seeding"),
        ("scoreType", "one score model + -scoreMatrix"),
        ("quallc", "low-complexity masking not needed for FASTA/FASTQ/SAM"),
    ]
    _compat_flag = [
        ("extend", "local 0-clamp + window pad extend alignments natively"),
        ("global", "piecewise path covers whole-query alignment"),
        ("noRefineAlignments", "ignored: a -bestn secondary on its SDP chain's span is "
                               "always refined along the chain"),
        ("noRefineAlign", "same"),
        ("refineBetweenAnchorsOnly", "piecewise/-alignContigs does this"),
        ("rbao", "same"),
        ("useDetailedSDP", "SDP gap fill is always exact"),
        ("nouseDetailedSDP", "same"),
        ("sdpbypass", "anchors feed the DP directly already"),
        ("allowAdjacentIndels", "DP emits whatever is optimal"),
        ("noFrontAlign", "local alignment trims ends by score"),
        ("onegap", "tools onegap / svrealign cover the SV path"),
        ("noSelf", "self-hits only arise in all-vs-all tooling"),
        ("outputByThread", "single ordered writer"),
        ("noStoreMapQV", "MAPQ is computed in the same fused program"),
        ("sortRefinedAlignments", "selection already sorts by score"),
        ("computeAlignProbability", "see -metrics JSON"),
        ("useQuality", "QV scoring is on whenever input has qualities"),
        ("preserveReadTitle", "titles are preserved verbatim already"),
        ("noPrintSubreadTitle", "whole-read titles (no region tables)"),
        ("forwardOnly2", None),
        ("p", "progress goes to stderr"),
        ("passthrough", "no daemon mode"),
        ("streaming", "batched pipeline streams by construction"),
        ("useTemp", "no temp files needed"),
        ("divideByAdapter", "adapter regions are HDF5-only"),
        ("ignoreRegions", "region tables are HDF5-only"),
        ("ignoreHQRegions", "same"),
    ]
    grp = p.add_argument_group("accepted for reference compatibility")
    for name, note in _compat_int:
        grp.add_argument(f"-{name}", type=float, default=None,
                        help=f"accepted; {note}")
    for name, note in _compat_flag:
        if name == "forwardOnly2":
            continue
        grp.add_argument(f"-{name}", action="store_true",
                        help=f"accepted; {note}" if note else "accepted")
    for name in ("accuracyPrior", "deletionPrior", "substitutionPrior",
                 "idsIndel", "minFrac", "minRatio", "overlap"):
        grp.add_argument(f"-{name}", type=float, default=None,
                        help="accepted; probability-model priors are folded "
                             "into the QV-scaled costs")
    for name in ("ctab", "seqdb", "findex", "regionTable", "fileType"):
        grp.add_argument(f"-{name}", default=None, metavar="FILE",
                        help="accepted; artifact auto-discovery covers this")
    p.add_argument("-fullMetrics", default=None, metavar="FILE",
                   help="write per-read metric rows (role of reference "
                        "MappingMetrics PrintFullList, MappingMetrics.h:307; "
                        "stage clocks are amortized per read — the TPU maps "
                        "whole batches in one fused program)")
    p.add_argument("-clusters", default=None, metavar="FILE",
                   help="write candidate-cluster statistics "
                        "(Blasr.cpp:4536 header; the reference fork itself "
                        "emits the header only — rows here carry per-"
                        "alignment cluster stats)")
    p.add_argument("-lcpBounds", default=None, metavar="FILE",
                   help="per read, the SA match-interval width at every "
                        "seed position (MapBySuffixArray.h:77-85)")
    return p


def params_from_args(args) -> MappingParams:
    """Flag bag -> MappingParams, applying MakeSane-style normalization."""
    best_n = max(1, args.bestn)
    n_cand = max(args.nCandidates, best_n)
    min_match = args.minMatch
    insertion = args.insertion if args.insertion is not None else args.indel
    deletion = args.deletion if args.deletion is not None else args.indel
    score_matrix = None
    if args.scoreMatrix is not None:
        vals = args.scoreMatrix.replace(",", " ").split()
        if len(vals) != 25:
            raise SystemExit(
                f"-scoreMatrix needs 25 values, got {len(vals)}"
            )
        score_matrix = tuple(int(v) for v in vals)
        if any(score_matrix[i * 5 + i] > 0 for i in range(4)):
            raise SystemExit("-scoreMatrix: diagonal (match) values must be <= 0")
    if args.nucmer:
        # SetEmulateNucmer (MappingParameters.h:547): exact-match oriented
        min_match = max(min_match, 30 if min_match == 14 else min_match)
        args.maxScore = min(args.maxScore, -200)
    if args.useSensitiveSearch:
        # SetForSensitivity (MappingParameters.h:560): more candidates,
        # lower match threshold
        n_cand = max(n_cand, 10)
        min_match = min(min_match, 12)
    best_n = 1 if args.printOnlyBest else best_n
    min_aln = args.minAlnLength
    if args.minAlnLength2 is not None:
        min_aln = max(min_aln, int(args.minAlnLength2))
    min_rd = args.minReadLength
    if args.minSubreadLength is not None:
        min_rd = max(min_rd, int(args.minSubreadLength))
    # -bandSize/-guidedAlignBandSize: round the half-width up to the lane
    # quantum the packed kernel supports
    nb_kw = {}
    if args.bandSize:
        full = 2 * args.bandSize
        nb = 32 if full <= 32 else (64 if full <= 64 else 128)
        nb_kw = dict(narrow_band=nb)
    samqv = None
    if args.samqv is not None:
        name_to_tag = {
            "InsertionQV": "iq", "DeletionQV": "dq", "SubstitutionQV": "sq",
            "MergeQV": "mq", "SubstitutionTag": "st", "DeletionTag": "dt",
        }
        bad = [n for n in args.samqv if n not in name_to_tag]
        if bad:
            raise SystemExit(f"-samqv: unknown QV names {bad}")
        samqv = tuple(name_to_tag[n] for n in args.samqv)
    match_kw = {}
    if args.match is not None:
        if args.match > 0:
            raise SystemExit("-match must be <= 0 (min-score convention)")
        match_kw["match_score"] = args.match
    if args.mismatch is not None:
        match_kw["mismatch_score"] = args.mismatch
    return MappingParams(
        min_match_length=min_match,
        anchor_stride=max(1, args.anchorStride),
        n_dp_candidates=args.dpCandidates or None,
        sdp_tuple_size=args.sdpTupleSize,
        forward_only=args.forwardOnly,
        min_map_qv=args.minMapQV,
        max_pct_identity=args.maxPctIdentity,
        min_avg_qual=args.minAvgQual,
        indel_rate=args.indelRate,
        samqv=samqv,
        **nb_kw,
        **match_kw,
        max_anchors_per_position=args.maxAnchorsPerPosition,
        max_anchors_per_read=args.maxAnchorsPerRead,
        n_candidates=n_cand,
        best_n=best_n,
        pval_type=args.pvaltype,
        insertion_score=insertion,
        deletion_score=deletion,
        affine_open=args.affineOpen,
        affine_extend=args.affineExtend,
        score_matrix=score_matrix,
        max_score=args.maxScore,
        min_pct_similarity=args.minPctIdentity,
        min_align_length=min_aln,
        min_read_length=min_rd,
        max_read_len=args.maxReadLen,
        batch_size=args.batchSize,
        place_repeats_randomly=args.placeRepeatsRandomly,
        random_seed=args.randomSeed,
        piecewise=args.alignContigs,
        sensitive_retry=args.useSensitiveSearch,
        ndevices=args.ndevices,
        ignore_qualities=args.ignoreQualities,
        min_expand=args.minExpand,
        max_expand=max(args.maxExpand, args.minExpand),
        # reference default false; -alignContigs preset enables it
        # (MappingParameters.h:350,469)
        remove_contained=args.removeContained or args.alignContigs,
        min_interval=args.minInterval,
        **(
            {}
            if args.useGuidedAlign is None
            else {"guided_band": args.useGuidedAlign}
        ),
        # -m 4 output is fully determined by coordinates + stats; only
        # SAM/m0-m5/piecewise consumers replay the per-base move strings,
        # so the m4 serving path skips shipping them over the host link
        # (see MappingParams.emit_moves). best_n > 1 forces them back on.
        emit_moves=bool(args.sam or args.m != 4 or args.alignContigs),
    )
