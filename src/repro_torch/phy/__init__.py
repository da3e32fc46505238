"""AI-native PHY on the port: OFDM substrate, coding chain, classical
DSP, the scenario registry and the receiver-pipeline subsystem."""
from repro_torch.phy import classical, coding, link, ofdm, scenarios
from repro_torch.phy.coding import CodeConfig, make_code
from repro_torch.phy.link import (
    PIPELINE_BUILDERS, ReceiverPipeline, RxStage, build_classical,
    build_pipeline, slot_metrics,
)
from repro_torch.phy.ofdm import Modem, make_modem, slot_from_numpy
from repro_torch.phy.scenarios import (
    LinkScenario, MCSLadder, all_scenarios, get_ladder, get_scenario,
    register_scenario, scenario_names,
)
