"""Abstract dataset: stateless record loading over an expanded visit list;
the port's copy of ``multimodal_fusion_fpn_tpu/data/abstract.py``, a
``torch.utils.data.Dataset`` (``__getitem__`` / ``__len__``).

Behavioral parity with the original project's
``common/abstract_dataloader.py``, re-designed for a threaded loader:

  * patient→visit expansion from a visits JSON (``:51-92``), selecting
    either explicit FileSetIds (``{'ids': [...]}``) or all visits of the
    listed patients;
  * virtual-epoch length ``multiplier * real_length`` with index modulo
    (``:95,117-118``);
  * ``load_record(index)`` is STATELESS (returns a fresh record, holds
    nothing on ``self``) so worker threads share one dataset object.
    The reference's image-reuse behavior — serve
    ``patches_from_single_image`` consecutive patches from one loaded
    image (``:94-101``) — is reproduced by the loader, which maps
    positions to load-indices in blocks of that size (see
    ``loader.DataLoader``).

Randomness for the transform pipeline is injected per call as a
``numpy.random.Generator`` so results are independent of thread
scheduling (stronger than the reference's per-worker seeding).
"""

from os.path import join
from typing import Dict, Optional, Union

import numpy as np
from torch.utils.data import Dataset

from multimodal_fusion_fpn_torch.data.transforms import (Compose,
                                                         deepcopy_record)


class AbstractDataset(Dataset):
    """Subclasses provide ``visit_row`` (visit JSON entry -> record row)
    and ``plan`` (modality-source table, see :mod:`.sources`)."""

    path: str
    visits: dict
    multiplier: int = 1
    patches_from_single_image: int = 1
    transforms: Optional[Compose] = None
    debug: bool = False

    # -- visit expansion -------------------------------------------------
    def visit_row(self, patient_id: str, visit: dict) -> Dict:
        raise NotImplementedError

    def expand_visits(self, patients: Union[dict, list]) -> list:
        """Flatten the visits JSON into record rows. A ``{'ids': [...]}``
        dict selects visits by FileSetId across all patients; a list of
        patient ids selects every visit of those patients."""
        if isinstance(patients, dict):
            wanted = set(patients["ids"])
            return [self.visit_row(pid, visit)
                    for pid, visits in self.visits.items()
                    for visit in visits
                    if visit["FileSetId"] in wanted]
        if isinstance(patients, list):
            return [self.visit_row(pid, visit)
                    for pid in patients
                    for visit in self.visits[pid]]
        raise ValueError("patients must be a dict or a list")

    # -- loading ---------------------------------------------------------
    @property
    def plan(self) -> Dict:
        raise NotImplementedError

    def load_record(self, index: int) -> Dict:
        """Load the raw (untransformed) record for ``index``; stateless."""
        from multimodal_fusion_fpn_torch.data.sources import resolve_plan
        return resolve_plan(self.rows[index % self.real_length], self.plan)

    def get_example(self, index: int,
                    rng: Optional[np.random.Generator] = None,
                    record: Optional[Dict] = None) -> Dict:
        """Transformed example for ``index``.  ``record`` short-circuits
        the disk load (the loader passes a cached record when several
        patches come from one image)."""
        if record is None:
            record = self.load_record(index)
        record = deepcopy_record(record)
        if self.transforms is not None:
            record = self.transforms(record, rng)
        if self.debug:
            for k, v in record.items():
                if hasattr(v, "shape"):
                    print("get_example", k, v.shape)
        return record

    def __getitem__(self, index):
        return self.get_example(index)

    def __len__(self):
        return int(self.multiplier * self.real_length)

    # -- shared init helper ----------------------------------------------
    def _finish_init(self, patients) -> None:
        assert patients is not None
        self.rows = self.expand_visits(patients)
        self.real_length = len(self.rows)


def hrf_visit_row(path: str, patient_id: str, visit: dict) -> Dict:
    """Row layout of the HRF visits JSON (FileSetId / DayInStudy /
    Position per visit; reference ``abstract_dataloader.py:60-79``)."""
    return {
        "path": join(path, visit["FileSetId"]),
        "FileSetId": visit["FileSetId"],
        "DayInStudy": visit["DayInStudy"],
        "VRCPatId": patient_id,
        "Position": visit["Position"],
        "slo_path": join(path, f"{patient_id}_{visit['Position']}",
                         str(visit["DayInStudy"])),
    }
