"""Per-dataset BOP configuration (the port's own copy of
cosypose_tpu/bop_config.py): input sizes (width, height), object dataset,
train / inference / test split names and synt+real mixtures of each BOP core
dataset, and the run ids under EXP_DIR of the detector, coarse and refiner
models trained for each.
"""

BOP_CONFIG = dict(
    hb=dict(
        input_resize=(640, 480),
        obj_ds_name="hb.models",
        train_pbr_ds_name=["hb.train.pbr"],
        inference_ds_name=["hb.test.bop19"],
        test_ds_name=[],
    ),
    icbin=dict(
        input_resize=(640, 480),
        obj_ds_name="icbin.models",
        train_pbr_ds_name=["icbin.train.pbr"],
        inference_ds_name=["icbin.test.bop19"],
        test_ds_name=["icbin.test.bop19"],
    ),
    itodd=dict(
        input_resize=(1280, 960),
        obj_ds_name="itodd.models",
        train_pbr_ds_name=["itodd.train.pbr"],
        inference_ds_name=["itodd.test.bop19"],
        test_ds_name=[],
    ),
    lm=dict(
        input_resize=(640, 480),
        obj_ds_name="lm.models",
        train_pbr_ds_name=["lm.train.pbr"],
        inference_ds_name=["lm.test.bop19"],
        test_ds_name=["lm.test.bop19"],
    ),
    lmo=dict(
        input_resize=(640, 480),
        obj_ds_name="lm.models",
        train_pbr_ds_name=["lm.train.pbr"],
        inference_ds_name=["lmo.test.bop19"],
        test_ds_name=["lmo.test.bop19"],
    ),
    tless=dict(
        input_resize=(720, 540),
        obj_ds_name="tless.cad",
        train_pbr_ds_name=["tless.train.pbr"],
        inference_ds_name=["tless.test.bop19"],
        test_ds_name=["tless.test.bop19"],
        train_synt_real_ds_names=[("tless.train.pbr", 4),
                                  ("tless.primesense.train", 1)],
    ),
    tudl=dict(
        input_resize=(640, 480),
        obj_ds_name="tudl.models",
        train_pbr_ds_name=["tudl.train.pbr"],
        inference_ds_name=["tudl.test.bop19"],
        test_ds_name=["tudl.test.bop19"],
        train_synt_real_ds_names=[("tudl.train.pbr", 10),
                                  ("tudl.train.real", 1)],
    ),
    ycbv=dict(
        input_resize=(640, 480),
        obj_ds_name="ycbv.models",
        train_pbr_ds_name=["ycbv.train.pbr"],
        inference_ds_name=["ycbv.test.bop19"],
        test_ds_name=["ycbv.test.bop19"],
        train_synt_real_ds_names=[("ycbv.train.pbr", 20),
                                  ("ycbv.train.synt", 1),
                                  ("ycbv.train.real", 3)],
    ),
)

# config-name → local run id (populated as models are trained in EXP_DIR)
PBR_DETECTORS = {ds: f"detector-bop-{ds}-pbr" for ds in BOP_CONFIG}
PBR_COARSE = {ds: f"bop-{ds}-pbr-coarse" for ds in BOP_CONFIG}
PBR_REFINER = {ds: f"bop-{ds}-pbr-refiner" for ds in BOP_CONFIG}
SYNT_REAL_DETECTORS = {ds: f"detector-bop-{ds}-synt+real" for ds in BOP_CONFIG}
SYNT_REAL_COARSE = {ds: f"bop-{ds}-synt+real-coarse" for ds in BOP_CONFIG}
SYNT_REAL_REFINER = {ds: f"bop-{ds}-synt+real-refiner" for ds in BOP_CONFIG}
