"""The paper's own experimental configuration (Table 1) — the campaign
that benchmarks/paper_campaign.py reproduces.

Not a neural architecture: LB4OMP's 'model' is the factorial experiment
design (applications x techniques x chunk parameters x nodes).  Kept as
a config module so the campaign is parameterized from one place and the
'+ paper's own' config slot in the assignment is explicit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    name: str
    cores: int                 # P without hyperthreading
    cores_ht: int              # P with hyperthreading
    sockets: int


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Table 1 of the paper, as data."""

    nodes: tuple[NodeConfig, ...] = (
        NodeConfig("miniHPC-Broadwell", 20, 40, 2),
        NodeConfig("miniHPC-KNL", 64, 256, 1),
        NodeConfig("PizDaint-Haswell", 12, 24, 1),
    )
    #: applications: (name, N iterations, T time-steps, modified loops)
    applications: tuple = (
        ("352.nab", 44_794, 1_002, 7),
        ("SPHYNX-EvrardCollapse", 1_000_000, 20, 2),
        ("GROMACS", 3_316_463, 10_000, 1),
        ("STREAM", 80_000_000, 1, 4),
        ("DIST", 1_000, 1, 5),
    )
    #: the OpenMP-standard + LB4OMP technique set of the campaign
    techniques: tuple = (
        "static", "gss", "ss", "tss",
        "fsc", "fac", "fac2", "tap", "wf2", "mfac",
        "bold", "awf", "awf_b", "awf_c", "awf_d", "awf_e", "af", "maf",
    )
    repetitions: int = 5
    repetitions_stream: int = 20

    def chunk_params(self, n: int, p: int) -> list[int]:
        """N/(2P), N/(4P), ..., down to 1 (Table 1)."""
        out = []
        c = n // (2 * p)
        while c > 1:
            out.append(c)
            c //= 2
        out.append(1)
        return out


CAMPAIGN = CampaignConfig()
