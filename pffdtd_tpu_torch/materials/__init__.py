"""Material fitting and DEF files (copy of pffdtd_tpu.materials)."""

from pffdtd_tpu_torch.materials.admittance import (  # noqa: F401
    convert_nabs_to_R,
    convert_R_to_Yn,
    convert_R_to_Zn,
    convert_Sabs_to_Yn,
    convert_Yn_to_R,
    compute_Rf_from_DEF,
    fit_to_Sabs_oct_11,
    to_DEF,
    from_DEF,
    write_freq_dep_mat,
    write_freq_ind_mat_from_Yn,
    write_freq_ind_mat_from_Zn,
)
