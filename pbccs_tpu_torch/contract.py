"""Pipeline tool-contract wrapper (L7).

Port of pbccs_tpu.contract: the same tool contract JSON naming this
package's command, and a resolved tool contract mapped onto
pbccs_tpu_torch.cli.run, which polishes on the card.

Parity target: bin/task_pbccs_ccs (reference, pbcommand-based): expose the
CCS task to SMRT-pipeline-style orchestrators via a tool contract JSON and
run resolved tool contracts by mapping their options onto the CLI.  This
implementation speaks the pbcommand JSON formats directly (emitting a tool
contract, consuming a resolved tool contract) without requiring pbcommand
to be installed; chunking is delegated to the orchestrator via --zmws
ranges, as in the reference (task_pbccs_ccs:6-9, 92-100)."""

from __future__ import annotations

import argparse
import json
import sys

TOOL_ID = "pbccs.tasks.ccs"
DRIVER = "python -m pbccs_tpu_torch.contract run-rtc "

# (option id suffix, type, default, description) -- reference Constants
# (task_pbccs_ccs:26-42)
TASK_OPTIONS = [
    ("min_snr", "float", 4.0, "Minimum SNR of input subreads"),
    ("min_read_score", "float", 0.75, "Minimum read score of input subreads"),
    ("min_length", "integer", 10, "Minimum length of subreads"),
    ("min_passes", "integer", 3, "Minimum number of full passes"),
    ("min_zscore", "float", -5.0, "Minimum Z-score of subreads"),
    ("max_drop_fraction", "float", 0.34,
     "Maximum fraction of subreads dropped before giving up"),
]


def tool_contract() -> dict:
    opts = {}
    for name, typ, default, desc in TASK_OPTIONS:
        oid = f"pbccs.task_options.{name}"
        opts[oid] = {
            "id": oid,
            "optionTypeId": f"pbsmrtpipe.option_types.{typ}",
            "default": default,
            "name": name.replace("_", " "),
            "description": desc,
        }
    return {
        "version": "1.0",
        "driver": {"exe": DRIVER, "serialization": "json"},
        "tool_contract_id": TOOL_ID,
        "tool_contract": {
            "tool_id": TOOL_ID,
            "name": "ccs",
            "description": "Generate circular consensus sequences (ccs) "
                           "from subreads.",
            "input_types": [{"file_type_id": "PacBio.DataSet.SubreadSet",
                             "id": "subread_set", "title": "SubreadSet",
                             "description": "Subread DataSet or .bam"}],
            "output_types": [{"file_type_id": "PacBio.DataSet.ConsensusReadSet",
                              "id": "bam_output", "title": "Consensus reads",
                              "default_name": "ccs",
                              "description": "Consensus reads in BAM format"},
                             {"file_type_id": "PacBio.FileTypes.csv",
                              "id": "report_csv", "title": "Results report",
                              "default_name": "ccs_report",
                              "description": "Per-ZMW yield report"}],
            "task_options": opts,
            "nproc": "$max_nproc",
            "is_distributed": True,
        },
    }


def run_resolved_tool_contract(rtc_path: str) -> int:
    """Map a resolved tool contract onto the native CLI and run it."""
    with open(rtc_path) as fh:
        rtc = json.load(fh)["resolved_tool_contract"]
    opts = rtc.get("options", {})
    o = lambda name, default: opts.get(f"pbccs.task_options.{name}", default)
    out_bam = rtc["output_files"][0]
    if out_bam.endswith(".consensusreadset.xml"):
        out_bam = out_bam[: -len(".consensusreadset.xml")] + ".bam"
    report = rtc["output_files"][1] if len(rtc["output_files"]) > 1 \
        else "ccs_report.csv"
    argv = [
        "--skipChemistryCheck",
        f"--reportFile={report}",
        f"--numThreads={rtc.get('nproc', 1)}",
        f"--minSnr={o('min_snr', 4.0)}",
        f"--minReadScore={o('min_read_score', 0.75)}",
        f"--minLength={o('min_length', 10)}",
        f"--minPasses={o('min_passes', 3)}",
        f"--minZScore={o('min_zscore', -5.0)}",
        f"--maxDropFraction={o('max_drop_fraction', 0.34)}",
        out_bam,
    ] + list(rtc["input_files"])
    from pbccs_tpu_torch.cli import run

    return run(argv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbccs_tpu_torch.contract")
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("emit-tool-contract", help="print the tool contract JSON")
    e.add_argument("-o", "--output", default="-")
    r = sub.add_parser("run-rtc", help="run a resolved tool contract")
    r.add_argument("rtc", help="resolved tool contract JSON path")
    args = p.parse_args(argv)
    if args.cmd == "emit-tool-contract":
        text = json.dumps(tool_contract(), indent=2)
        if args.output == "-":
            print(text)
        else:
            from pbccs_tpu_torch.resilience.resources import atomic_output

            with atomic_output(args.output, "contract") as fh:
                fh.write(text)
        return 0
    return run_resolved_tool_contract(args.rtc)


if __name__ == "__main__":
    sys.exit(main())
