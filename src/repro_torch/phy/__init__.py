"""AI-native PHY on the port: OFDM substrate, coding chain, classical
DSP, the neural receivers' models, the scenario registry and the
receiver-pipeline subsystem."""
from repro_torch.phy import classical, coding, link, models, ofdm, scenarios
from repro_torch.phy.coding import CodeConfig, make_code
from repro_torch.phy.link import (
    PIPELINE_BUILDERS, ReceiverPipeline, RxStage, build_cevit,
    build_classical, build_deeprx, build_pipeline, slot_metrics,
)
from repro_torch.phy.models import (
    CEViTConfig, DeepRxConfig, cevit_apply, cevit_params_from_numpy,
    deeprx_apply, deeprx_params_from_numpy,
)
from repro_torch.phy.ofdm import Modem, make_modem, slot_from_numpy
from repro_torch.phy.scenarios import (
    LinkScenario, MCSLadder, all_scenarios, get_ladder, get_scenario,
    register_scenario, scenario_names,
)
