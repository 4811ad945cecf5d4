"""bcalm-compatible command-line interface.

Option surface mirrors the reference (union of README.md:11-25,74,
src/bcalm_1.cpp:16-43 incl. hidden options, scripts/pufferize.py:143 and
the circular-unitig test CMD files — SURVEY.md §6 'Config/flag system'):

    bcalm-tpu -in reads.fa -kmer-size 31 -abundance-min 2 [-out prefix] ...

Artifacts follow the reference naming proven by test/simple_test.sh:
input X.fa -> X.unitigs.fa, intermediate store X_btpu/ (the .h5 analog,
deleted after a successful run like src/bcalm_1.cpp:64-77).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from bcalm_tpu.version import version_string
from bcalm_tpu.utils.options import OptionFailure, OptionsParser
from bcalm_tpu.utils.timeinfo import TimeInfo, peak_rss_mb


def build_parser() -> OptionsParser:
    p = OptionsParser("bcalm-tpu")
    # core graph options (GraphUnitigsTemplate::getOptionsParser analog)
    p.one_param("-in", "input reads (fasta/fastq[.gz] or file of filenames)",
                mandatory=True)
    p.one_param("-out", "output prefix", default=None)
    p.one_param("-kmer-size", "k-mer size", default="31")
    p.one_param("-abundance-min",
                "filter k-mers seen strictly fewer times than this",
                default="2")
    p.one_param("-abundance-max", "max k-mer abundance", default=str(2**31 - 1),
                visible=False)
    p.one_param("-minimizer-size", "minimizer size", default="10")
    p.one_param("-minimizer-type", "0: lexicographic, 1: frequency-based",
                default="1")
    p.one_param("-repartition-type", "0: uniform, 1: frequency-balanced",
                default="1")
    p.one_param("-max-memory", "max device memory in MB", default="0")
    p.one_param("-max-disk", "max disk for multi-pass staging in MB "
                             "(0 = unlimited)", default="0")
    p.one_param("-nb-cores", "host worker threads (0=auto)", default="0")
    p.one_param("-verbose", "verbosity level", default="1")
    p.no_param("-all-abundance-counts",
               "emit ab:Z: per-k-mer abundance vectors in headers")
    # stage-skipping / resume flags (scripts/pufferize.py:143)
    p.no_param("-skip-bcalm", "reuse stored counts, skip counting+compaction input")
    p.no_param("-skip-bglue", "with -skip-bcalm: skip gluing")
    p.no_param("-redo-links", "recompute L: link annotations of an existing "
                              "unitigs file")
    p.one_param("-nb-glue-partitions", "legacy: glue partition count",
                default="0", visible=False)
    # hidden gatb options surfaced for parity (src/bcalm_1.cpp:34-37)
    p.one_param("-histo-max", "max histogram bin", default="10000",
                visible=False)
    p.one_param("-solidity-kind", "multi-sample solidity: sum|min|max",
                default="sum", visible=False)
    p.one_param("-abundance-min-threshold",
                "cap for '-abundance-min auto'", default="20",
                visible=False)
    p.one_param("-solid-kmers-out", "write solid (kmer,count) pairs to file",
                default=None, visible=False)
    # glue diagnostics (legacy --only-uf/--uf-stats, src/bcalm_1.cpp:26-27)
    p.no_param("-only-uf", "stop after chain labeling (UF analog); no "
                           "unitig assembly or output", visible=False)
    p.no_param("-uf-stats", "print chain-decomposition (UF-class) stats",
               visible=False)
    # accelerator-specific
    p.one_param("-devices", "number of devices to use (0 = all)", default="0")
    p.one_param("-server", "serve build requests on a unix socket "
                           "(keep-alive mode: amortizes backend init + "
                           "program loads across invocations)",
                default=None, visible=False)
    p.one_param("-connect", "send this command line to a -server socket "
                            "instead of running locally",
                default=None, visible=False)
    p.no_param("-version", "show version")
    p.no_param("-help", "show this help")
    p.no_param("-h", "show this help", visible=False)
    return p


def default_prefix(in_path: str) -> str:
    base = os.path.basename(in_path)
    for ext in (".gz",):
        if base.endswith(ext):
            base = base[: -len(ext)]
    root, ext = os.path.splitext(base)
    return root if ext in (".fa", ".fasta", ".fq", ".fastq", ".txt", ".list") \
        else base


def redo_links(unitigs_path: str, k: int, verbose: int) -> None:
    """Recompute all L: entries of an existing unitigs file in place
    (LinkTigs re-run, the `-redo-links` workflow of pufferize.py:139-144)."""
    from bcalm_tpu import engine
    from bcalm_tpu.io import fasta_writer
    import numpy as np

    seqs, headers = fasta_writer.parse_unitigs_fasta(unitigs_path)
    links = engine.link_join(seqs, k)
    us = engine.UnitigSet(
        k=k, seqs=seqs,
        kc=np.zeros(len(seqs), np.int64),
        abundances=[np.zeros(max(1, len(s) - k + 1), np.int32) for s in seqs],
        circular=np.zeros(len(seqs), bool),
        links=links,
    )
    # preserve original non-link fields, replace links (grouped by source)
    by_src: dict = {}
    for (u, su, v, sv) in links:
        by_src.setdefault(u, []).append(f"L:{su}:{v}:{sv}")
    out_lines = []
    for i, h in enumerate(headers):
        toks = [t for t in h.split(" ") if t and not t.startswith("L:")]
        toks.extend(by_src.get(i, ()))
        out_lines.append(">" + " ".join(toks))
    with open(unitigs_path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(out_lines[i] + "\n")
            f.write(s + "\n")
    if verbose:
        print(f"re-linked {len(seqs)} unitigs -> {unitigs_path}")


def _adapt_max_len(bank, cfg, max_memory_mb: int = 0) -> None:
    """Size the block geometry + counting chunk to the input.

    max_len: the default 512-base rows left 150 bp reads at ~25% chunk
    occupancy (sentinel slots cost full sort capacity); sample the bank's
    read lengths instead (longer outliers still stream exactly as
    overlapping windows).

    chunk: at >=64M-occurrence scale the LSM merge traffic dominates the
    per-chunk sort and 2^24 chunks amortize it better than 2^23;
    estimate the occurrence total from file sizes (gz ~3x) and pick
    accordingly unless -max-memory already chose."""
    sampled = bank.sample_max_len()
    if sampled >= cfg.k:
        cfg.max_len = max(cfg.k + 1, min(512, -(-sampled // 16) * 16))
    raw = sum(os.path.getsize(p) for p in bank.paths
              if os.path.exists(p))
    mult = 3.0 if any(str(p).endswith(".gz") for p in bank.paths) else 1.0
    bases = raw * mult * 0.9
    if sampled > 0 and bases > 0:
        occ = bases * max(0.1, 1.0 - (cfg.k - 1) / max(cfg.k, sampled))
        cfg.est_total_occ = int(occ)
    if max_memory_mb <= 0 and cfg.est_total_occ >= (1 << 26):
        cfg.chunk_kmers = 1 << 24


def _input_blocks(bank, cfg, verbose: int, nb_cores: int = 0):
    """Packed-block stream: native C++ parser when available (with host
    prefetch overlapping device compute), else python.

    One big file (the common production case) fans its decompressed
    stream out to a parse-worker pool (io.parallel_ingest — the gatb
    Dispatcher -nb-cores analog, SURVEY.md §3.2); multiple files fan out
    per file as before."""
    from bcalm_tpu.io import bank_binary, native as native_mod
    from bcalm_tpu.io import packing
    from bcalm_tpu.utils import dispatcher

    binary = [p for p in bank.paths if bank_binary.is_binary_bank(p)]
    if binary and len(binary) == len(bank.paths):
        for p in bank.paths:
            yield from bank_binary.read_bank(p)
        return

    if native_mod.available():
        if verbose > 1:
            print("using native ingest (libbcalmio)")
        workers = nb_cores if nb_cores > 0 else min(4, max(2, len(bank.paths)))
        if (len(bank.paths) == 1 and workers > 1
                and native_mod.mem_available()):
            from bcalm_tpu.io import parallel_ingest

            yield from dispatcher.prefetch(
                parallel_ingest.iter_blocks_parallel(
                    bank.paths[0], cfg.k, block_reads=cfg.block_reads,
                    max_len=cfg.max_len, n_workers=workers))
            return
        yield from dispatcher.parallel_files(
            bank.paths,
            lambda p: native_mod.iter_blocks_native(
                p, cfg.k, block_reads=cfg.block_reads, max_len=cfg.max_len
            ),
            n_workers=workers,
        )
    else:
        yield from dispatcher.prefetch(
            packing.iter_blocks(
                bank.sequences(), cfg.k, block_reads=cfg.block_reads,
                max_len=cfg.max_len,
            )
        )


def serve(socket_path: str) -> int:
    """Keep-alive server: one process holds the initialized backend and
    every loaded program; each connection carries one JSON request
    {"argv": [...]} and receives {"rc": N, "output": "..."}.  Backend
    start-up and program loads are paid once instead of per run.  The
    server never replaces its own process (a compaction OOM answers rc 1
    and the client resumes with -skip-bcalm)."""
    import contextlib
    import io
    import json
    import socket as socket_mod

    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(4)
    print(f"bcalm-tpu server listening on {socket_path}", flush=True)
    while True:
        conn, _ = srv.accept()
        with conn:
            try:
                data = b""
                while not data.endswith(b"\n"):
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        break
                    data += chunk
                if not data.strip():
                    continue
                try:
                    req = json.loads(data)
                except ValueError:
                    conn.sendall(b'{"rc": 1, "output": "bad request"}\n')
                    continue
                if req.get("op") == "shutdown":
                    conn.sendall(b'{"rc": 0, "output": "bye"}\n')
                    return 0
                buf = io.StringIO()
                try:
                    with contextlib.redirect_stdout(buf):
                        rc = main(list(req.get("argv", [])),
                                  allow_exec=False)
                except SystemExit as e:   # argv errors
                    rc = e.code if isinstance(e.code, int) else 1
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    buf.write(f"server error: {e!r}\n")
                    rc = 1
                conn.sendall(json.dumps(
                    {"rc": rc, "output": buf.getvalue()}).encode() + b"\n")
            except OSError:
                # client vanished mid-request/reply: keep serving — the
                # whole point of the keep-alive process is surviving
                # flaky clients
                continue


def connect(socket_path: str, argv: List[str]) -> int:
    """Client side of -server: forward one command line, print output."""
    import json
    import socket as socket_mod

    cli = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    cli.connect(socket_path)
    cli.sendall(json.dumps({"argv": argv}).encode() + b"\n")
    data = b""
    while not data.endswith(b"\n"):
        chunk = cli.recv(1 << 16)
        if not chunk:
            break
        data += chunk
    resp = json.loads(data)
    sys.stdout.write(resp.get("output", ""))
    return int(resp.get("rc", 1))


def _respawn_skip_bcalm(argv: List[str], err: Exception,
                        allow_exec: bool = True) -> Optional[int]:
    """Continue a compaction-OOM'd run in a fresh process.

    After a long multi-pass count the device allocator can be too
    fragmented for the contiguous multi-GB junction sort even though a
    fresh process compacts the identical solid set fine (docs/OOC.md).
    The solid set is already checkpointed, so the identical command is
    re-executed with -skip-bcalm: compaction restarts on a clean
    allocator.  exec REPLACES this process, so its device memory
    reservation is released before the new one starts (a child process
    would find the card still held by its parent).  The reference's
    staged pipeline restarts stages from its .h5 disk checkpoint the same
    way (test/simple_test.sh:4-9).

    Returns None when respawning is not applicable (already a respawned
    process, or the user asked for -skip-bcalm themselves), 1 when exec
    is not allowed (the -server process must keep serving); otherwise
    never returns."""
    if os.environ.get("BTPU_NO_RESPAWN") == "1" or "-skip-bcalm" in argv:
        return None
    if not allow_exec:
        print(f"{err}", file=sys.stderr)
        return 1
    import traceback

    traceback.print_exception(err)
    print("restarting compaction in a fresh process with -skip-bcalm",
          file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, BTPU_NO_RESPAWN="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    os.execve(sys.executable,
              [sys.executable, "-m", "bcalm_tpu", *argv, "-skip-bcalm"], env)


def main(argv: Optional[List[str]] = None, allow_exec: bool = True) -> int:
    """Run one bcalm command line.  allow_exec=False (the -server loop)
    forbids replacing the process on a compaction OOM."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-version" in argv or "--version" in argv:
        print(version_string())
        return 0
    if "-server" in argv:
        i = argv.index("-server")
        if i + 1 >= len(argv):
            print("-server requires a socket path", file=sys.stderr)
            return 1
        return serve(argv[i + 1])
    if "-connect" in argv:
        i = argv.index("-connect")
        if i + 1 >= len(argv):
            print("-connect requires a socket path", file=sys.stderr)
            return 1
        sock = argv[i + 1]
        rest = argv[:i] + argv[i + 2:]
        return connect(sock, rest)
    parser = build_parser()
    try:
        props = parser.parse(argv)
    except OptionFailure as e:
        print(str(e), file=sys.stderr)
        return 1
    if props.get_bool("-help") or props.get_bool("-h"):
        print(parser.usage())
        return 0

    # persistent XLA cache: every process would otherwise recompile each
    # program shape it runs
    from bcalm_tpu.utils.jaxcache import enable_cache

    enable_cache()

    from bcalm_tpu import engine
    from bcalm_tpu.io import bank as bank_mod
    from bcalm_tpu.io import fasta_writer, packing
    from bcalm_tpu.storage.store import Store

    k = props.get_int("-kmer-size")
    verbose = props.get_int("-verbose")
    in_path = props.get_str("-in")
    prefix = props.get_str("-out") or default_prefix(in_path)
    unitigs_path = prefix + ".unitigs.fa"
    ti = TimeInfo()

    if props.get_bool("-redo-links"):
        if not os.path.exists(unitigs_path):
            print(f"-redo-links: {unitigs_path} not found", file=sys.stderr)
            return 1
        redo_links(unitigs_path, k, verbose)
        return 0

    amin_raw = props.get_str("-abundance-min")
    auto_amin = amin_raw == "auto"
    cfg = engine.EngineConfig(
        k=k,
        abundance_min=1 if auto_amin else int(amin_raw),
        abundance_max=props.get_int("-abundance-max"),
        histo_max=props.get_int("-histo-max"),
    )
    engine.configure_chunk(cfg, props.get_int("-max-memory"))
    solidity_kind = props.get_str("-solidity-kind")
    store = Store(prefix)
    # multi-pass staging: packed blocks re-stream from a memmap file under
    # the store dir when the distinct set exceeds device residency — the
    # disk-staged (pass x partition) analog honoring -max-disk
    # (/root/reference/README.md:103)
    cfg.spill_dir = store.path
    cfg.max_disk_mb = props.get_int("-max-disk")
    skip_bcalm = props.get_bool("-skip-bcalm")
    skip_bglue = props.get_bool("-skip-bglue")
    if skip_bglue and not skip_bcalm:
        # the chain checkpoint only exists relative to stored counts; a
        # recount would silently recompute the glue it asked to skip
        print("-skip-bglue requires -skip-bcalm (resume workflow: run "
              "with -only-uf, then -skip-bcalm -skip-bglue)",
              file=sys.stderr)
        return 1

    solid = counts = minpos = histo = None
    built_us = None
    stats = {}
    if skip_bcalm:
        # EXPLICIT resume only (scripts/pufferize.py:143 semantics): a
        # store is never reused implicitly, and the stored counting
        # parameters are validated — reusing post-filter counts with a
        # LOWER cutoff would silently drop k-mers, so that is refused; a
        # HIGHER cutoff is re-filtered from the stored counts.
        if not store.exists():
            print(f"-skip-bcalm: no stored counts at {store.path}",
                  file=sys.stderr)
            return 1
        try:
            with ti.timer("load_counts"):
                solid, counts, minpos = store.read_counts(k)
        except ValueError as e:
            print(f"-skip-bcalm: {e}", file=sys.stderr)
            return 1
        scfg = store.config()
        stored_amin = int(scfg.get("abundance_min", 1))
        stored_amax = int(scfg.get("abundance_max", 2**31 - 1))
        if auto_amin:
            cfg.abundance_min = stored_amin
        if cfg.abundance_min < stored_amin or cfg.abundance_max > stored_amax:
            print(
                f"-skip-bcalm: stored counts were filtered at abundance "
                f"[{stored_amin}, {stored_amax}]; cannot widen to "
                f"[{cfg.abundance_min}, {cfg.abundance_max}] — recount "
                f"without -skip-bcalm", file=sys.stderr)
            return 1
        if cfg.abundance_min > stored_amin or cfg.abundance_max < stored_amax:
            keep = ((counts >= cfg.abundance_min)
                    & (counts <= cfg.abundance_max))
            solid, counts = solid[:, keep], counts[keep]
            if minpos is not None:
                minpos = minpos[keep]
        histo = store.read_histogram()
        if verbose:
            print(f"reusing stored counts: {solid.shape[1]} solid k-mers "
                  f"({store.path})")

    # multi-chip build: -devices N > 1 runs the mesh-sharded counting +
    # compaction pipeline (parallel.pipeline / parallel.distcompact);
    # the reference has no analog (single node, SURVEY.md §3.3)
    n_dev_req = props.get_int("-devices")
    if solid is None and n_dev_req > 1:
        if not os.path.exists(in_path):
            print(f"input not found: {in_path}", file=sys.stderr)
            return 1
        if solidity_kind != "sum":
            # multi-sample min/max solidity needs per-bank counting; the
            # mesh path would silently aggregate as 'sum' — refuse rather
            # than diverge
            print("-devices with -solidity-kind min/max is not supported "
                  "yet; run without -devices", file=sys.stderr)
            return 1
        import jax

        from bcalm_tpu.parallel import pipeline as par

        avail = len(jax.devices())
        if n_dev_req > avail:
            print(f"-devices {n_dev_req}: only {avail} devices available",
                  file=sys.stderr)
            return 1
        bank = bank_mod.Bank.open(in_path)
        _adapt_max_len(bank, cfg, props.get_int("-max-memory"))
        mesh = par.make_mesh(n_dev_req)
        mcfg = par.MinimizerConfig(
            m=props.get_int("-minimizer-size"),
            minimizer_type=props.get_int("-minimizer-type"),
            repartition_type=props.get_int("-repartition-type"),
        )
        with ti.timer("build_distributed"):
            us = par.distributed_build(
                bank.sequences(), cfg, mesh, mcfg,
                auto_amin_cap=(props.get_int("-abundance-min-threshold")
                               if auto_amin else None),
                store=store, reread=lambda: bank.sequences())
        if auto_amin and verbose:
            print(f"auto abundance-min = {cfg.abundance_min}")
        with ti.timer("write"):
            with open(unitigs_path, "w") as f:
                fasta_writer.write_fasta(
                    us, f,
                    all_abundance_counts=props.get_bool("-all-abundance-counts"),
                )
        # counting output + repartition persisted during the build serve
        # crash-resume (-skip-bcalm); a completed run cleans up like the
        # reference removes its .h5 (src/bcalm_1.cpp:64-77)
        store.remove()
        if verbose:
            print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path} "
                  f"({mesh.devices.size} devices)")
            for key, val in sorted(us.stats.items()):
                print(f"    [{key}] {val}")
            for name, secs in ti.report().items():
                print(f"    [time:{name}] {secs:.2f}s")
        return 0

    if solid is None:
        if not os.path.exists(in_path):
            print(f"input not found: {in_path}", file=sys.stderr)
            return 1
        # -minimizer-*/-repartition-type steer the mesh repartition table;
        # the single-device sort path has no minimizer routing, so warn
        # instead of silently ignoring them
        for flag, default in (("-minimizer-size", "10"),
                              ("-minimizer-type", "1"),
                              ("-repartition-type", "1")):
            if props.get_str(flag) != default:
                print(f"note: {flag} only affects the -devices N mesh "
                      f"path; ignored on the single-device path",
                      file=sys.stderr)
        bank = bank_mod.Bank.open(in_path)
        _adapt_max_len(bank, cfg, props.get_int("-max-memory"))
        with ti.timer("count"):
            from bcalm_tpu.utils.logging import Progress

            progress = Progress("reads packed", enabled=verbose >= 1)
            ingest_t = {"t0": None, "t1": None, "bases": 0}

            def counted_blocks(b=None):
                import time as _t
                src = b if b is not None else bank
                if ingest_t["t0"] is None:
                    ingest_t["t0"] = _t.time()
                for blk in _input_blocks(src, cfg, verbose,
                                         nb_cores=props.get_int("-nb-cores")):
                    progress.update(int((blk.lengths > 0).sum()))
                    ingest_t["bases"] += int(blk.lengths.sum())
                    ingest_t["t1"] = _t.time()
                    yield blk

            import numpy as np

            if solidity_kind != "sum" and len(bank.paths) > 1:
                # multi-sample solidity (min/max): count each bank
                # separately at abundance 1, combine per solidity kind
                import dataclasses
                cfg1 = dataclasses.replace(
                    cfg, abundance_min=1, abundance_max=2**31 - 1)
                runs = []
                stats = {}
                for p in bank.paths:
                    sub = bank_mod.Bank([p])
                    s_i, c_i, _, _, st = engine.count_and_filter(
                        counted_blocks(sub), cfg1,
                        reread=lambda sub=sub: _input_blocks(
                            sub, cfg, verbose,
                            nb_cores=props.get_int("-nb-cores")))
                    runs.append((s_i, c_i))
                    for key in ("reads", "bases", "kmer_occurrences"):
                        stats[key] = stats.get(key, 0) + st.get(key, 0)
                lanes, agg = engine.combine_sample_counts(
                    runs, solidity_kind, k=cfg.k)
                histo = np.bincount(
                    np.minimum(agg, cfg.histo_max),
                    minlength=cfg.histo_max + 1).astype(np.int32)
                if auto_amin:
                    cfg.abundance_min = engine.auto_abundance_min(
                        histo, props.get_int("-abundance-min-threshold"))
                keep = ((agg >= cfg.abundance_min)
                        & (agg <= cfg.abundance_max))
                solid, counts = lanes[:, keep], agg[keep]
                stats["distinct_kmers"] = int(lanes.shape[1])
                stats["solid_kmers"] = int(solid.shape[1])
            else:
                # device-resident fast path: counting, solidity filter,
                # compaction and the store checkpoint fetch all stay on
                # device (no solid-table host round trip between stages).
                # reread re-opens the on-disk bank for multi-pass OOC
                # counting, so single-pass runs never stage the packed
                # input to disk (the block cache is for library callers
                # with one-shot iterators only)
                try:
                    built_us = engine.build_from_blocks(
                        counted_blocks(), cfg, store=store,
                        reread=lambda: _input_blocks(
                            bank, cfg, verbose,
                            nb_cores=props.get_int("-nb-cores")),
                        auto_amin_cap=(props.get_int(
                            "-abundance-min-threshold")
                            if auto_amin else None),
                        only_uf=props.get_bool("-only-uf"),
                        uf_stats=props.get_bool("-uf-stats"),
                        solidity_kind=solidity_kind)
                except engine.CompactionOOM as e:
                    rc = _respawn_skip_bcalm(argv, e, allow_exec)
                    if rc is not None:
                        return rc
                    raise
            progress.done()
            if built_us is not None and ingest_t["t1"]:
                # stream rate measured over the packing loop (overlapped
                # with device compute, so a lower bound on parser speed)
                dt = max(1e-6, ingest_t["t1"] - ingest_t["t0"])
                built_us.stats["ingest_mbps"] = round(
                    ingest_t["bases"] / 1e6 / dt, 1)
            if auto_amin and verbose:
                print(f"auto abundance-min = {cfg.abundance_min}")
        if solid is not None:
            with ti.timer("store"):
                store.write_counts(
                    solid, counts, k, histogram=histo, minpos=minpos,
                    config={"abundance_min": cfg.abundance_min,
                            "abundance_max": cfg.abundance_max,
                            "solidity_kind": solidity_kind})

    only_uf = props.get_bool("-only-uf")
    solid_out = props.get_str("-solid-kmers-out")
    if solid_out:
        from bcalm_tpu.models import lanes as ln
        if solid is None:   # device-resident path: read the checkpoint
            solid, counts, _mp = store.read_counts(k)
        with open(solid_out, "w") as f:
            for i in range(solid.shape[1]):
                f.write(f"{ln.int_to_string(ln.lanes_to_int(solid[:, i]), k)}\t"
                        f"{int(counts[i])}\n")

    if built_us is not None:
        us = built_us
    else:
        chain_info = None
        if skip_bglue:
            # resume from the chain-decomposition checkpoint (written by
            # -only-uf) — the glue-file analog of the reference's staged
            # pipeline (unitigs.fa.glue* files, test/simple_test.sh:6)
            if not (skip_bcalm and store.has_chains()):
                print("-skip-bglue: no chain checkpoint in store (run with "
                      "-only-uf first, resume with -skip-bcalm -skip-bglue)",
                      file=sys.stderr)
                return 1
            try:
                chain_info = store.read_chains(k, int(solid.shape[1]))
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
            if verbose:
                print("reusing stored chain decomposition (skip-bglue)")
        with ti.timer("compact"):
            try:
                us = engine.compact_from_counts(
                    solid, counts, cfg, only_uf=only_uf,
                    uf_stats=props.get_bool("-uf-stats"),
                    chain_info=chain_info, minpos_np=minpos)
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
        us.stats.update(stats)
        us.histogram = histo
    if only_uf and us.chain_info is not None:
        store.write_chains(us.chain_info, k,
                           int(us.stats.get("solid_kmers", 0)))

    if not only_uf:
        with ti.timer("write"):
            with open(unitigs_path, "w") as f:
                fasta_writer.write_fasta(
                    us, f,
                    all_abundance_counts=props.get_bool("-all-abundance-counts"),
                )

    # end-of-run cleanup, mirroring the reference's .h5 removal (kept when
    # a later resume stage will need it, like -skip-bcalm workflows expect)
    if not only_uf:
        store.remove()

    if verbose:
        if only_uf:
            print(f"-only-uf: stopped after chain labeling "
                  f"({us.stats.get('uf_classes', 0)} classes)")
        else:
            print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path}")
        for key, val in sorted(us.stats.items()):
            print(f"    [{key}] {val}")
        for name, secs in ti.report().items():
            print(f"    [time:{name}] {secs:.2f}s")
        print(f"    [peak_rss_mb] {peak_rss_mb():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
