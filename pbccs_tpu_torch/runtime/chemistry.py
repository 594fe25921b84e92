"""Chemistry identification: (BindingKit, SequencingKit, BasecallerVersion)
triples -> chemistry names, plus the hardcoded P6-C4 acceptance gate.

Parity: reference ChemistryMapping/ChemistryTriple (include/pacbio/ccs/
ChemistryMapping.h:49-72, ChemistryTriple.h:46-85, parsing
ChemistryMapping.cpp:53-83) and the CLI gate VerifyChemistry
(src/main/ccs.cpp:263-281).

Copy of pbccs_tpu.runtime.chemistry.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

from pbccs_tpu_torch.io.bam import ReadGroupInfo


@dataclasses.dataclass(frozen=True)
class ChemistryTriple:
    binding_kit: str
    sequencing_kit: str
    major_version: str  # "major.minor" of the basecaller/software version

    @staticmethod
    def from_strings(binding_kit: str, sequencing_kit: str,
                     software_version: str) -> "ChemistryTriple":
        parts = software_version.split(".")
        major = ".".join(parts[:2]) if len(parts) >= 2 else software_version
        return ChemistryTriple(binding_kit, sequencing_kit, major)


class ChemistryMapping:
    """Parse a mapping XML: <Mapping><BindingKit/><SequencingKit/>
    <SoftwareVersion/><SequencingChemistry/></Mapping> entries, with a
    DefaultSequencingChemistry fallback."""

    def __init__(self, xml_path: str):
        self.mapping: dict[ChemistryTriple, str] = {}
        self.default: str | None = None
        root = ET.parse(xml_path).getroot()
        for m in root.iter():
            if m.tag.endswith("Mapping"):
                get = lambda tag: next(
                    (c.text or "" for c in m if c.tag.endswith(tag)), "")
                chem = get("SequencingChemistry")
                if not chem:
                    continue
                bk, sk, sv = (get("BindingKit"), get("SequencingKit"),
                              get("SoftwareVersion"))
                if bk or sk or sv:
                    self.mapping[ChemistryTriple.from_strings(bk, sk, sv)] = chem
                else:
                    self.default = chem
            elif m.tag.endswith("DefaultSequencingChemistry"):
                self.default = m.text or None

    def find(self, triple: ChemistryTriple) -> str | None:
        return self.mapping.get(triple, self.default)


def verify_chemistry(rg: ReadGroupInfo) -> bool:
    """The reference's hardcoded P6-C4-only gate (ccs.cpp:263-281)."""
    bc_major = ".".join(rg.basecaller_version.split(".")[:2])
    if bc_major not in ("2.1", "2.3"):
        return False
    if rg.sequencing_kit != "100356200":
        return False
    return rg.binding_kit in ("100356300", "100372700")
