"""Host-side streaming I/O: SHAPEIT hap/legend/indv, PLINK ped/map, VCF,
and the small scenario table formats (gen-info, maps, CV tables, migration).
"""

from geneevolve_tpu_torch.io import hap, plink, tables, vcf  # noqa: F401
