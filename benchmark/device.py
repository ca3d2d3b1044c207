"""The card a run measures: its presence, name, power limit, SMs and
clock, and its memory."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    """The run asks for more cards than the machine has."""


def require(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs only on a GPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def _smi(query: str) -> list:
    """nvidia-smi's readings of card 0, one a field of `query`, or "not
    read" for each."""
    fields = query.count(",") + 1
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ["not read"] * fields
    got = [x.strip() for x in out.strip().splitlines()[0].split(",")]
    return got if len(got) == fields else ["not read"] * fields


def card(dev: torch.device) -> dict:
    """Name, power limit, SM count and maximum SM clock of the card, and
    sm_hz, the SMs times that clock in Hz."""
    props = torch.cuda.get_device_properties(dev)
    mhz, watts = _smi("clocks.max.sm,power.limit")
    try:
        max_mhz = float(mhz)
    except ValueError:
        raise RuntimeError(f"nvidia-smi gave no maximum SM clock: {mhz!r}")
    return {"kind": torch.cuda.get_device_name(dev), "power_limit_w": watts,
            "sms": props.multi_processor_count, "max_sm_mhz": max_mhz,
            "sm_hz": props.multi_processor_count * max_mhz * 1e6}


def peak_reserved(dev: torch.device) -> int:
    return torch.cuda.max_memory_reserved(dev)


def alloc_retries(dev: torch.device) -> int:
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
